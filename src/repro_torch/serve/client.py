"""Synchronous client for the selection serving front end (a copy of
``repro.serve.client``).

One TCP connection, strict request → response.  The client is deliberately
thin — ``repro_torch.serve.protocol`` framing plus op helpers — so the whole wire
contract stays visible in ``docs/serving.md``.  Server-side failures
(``shed``, ``timeout``, ``draining``, ``unknown_job``, ...) surface as
:class:`ServeError` with the wire ``code`` (and the full decoded response
on ``.response``, e.g. ``round_desync`` carries the ``expected`` round).

Fault tolerance is layered on the server's determinism:

* **broken connections never poison the framing state** — a transport
  error mid-call (``ProtocolError`` / ``OSError``) marks the socket broken
  and closes it, so the next call reconnects from a clean frame boundary
  instead of desynchronizing the length-prefixed stream.
* **retries with exponential backoff + seeded jitter** — ``retries=N``
  makes ``call`` retry transport failures and server ``retry`` answers
  (the transport's "engine crashed mid-dispatch" response).  Only
  *idempotent* requests retry: control reads (``hello``/``stats``) and
  ``tick``s that carry a ``round`` — the server's per-job response cache
  answers a replayed round without double-applying feedback.  A round-less
  tick is NOT safe to resend blind, so it never auto-retries.
* **round tracking** — the client remembers each admitted job's next round
  and tags every ``tick`` with it, which is what makes the retry loop (and
  recovery-driven replay after a server restart) safe end to end.

Feedback for ``tick`` can be posted three ways (see ``protocol``): packed
success bits (``bits=...``, sync servers), packed lag codes (``lags=...``,
async servers), or a plain list (``x=...``).
"""
from __future__ import annotations

import random
import socket
import time
from typing import Dict, Optional

from . import protocol

__all__ = ["ServeClient", "ServeError"]

# server answers a retry of these can't corrupt state even without a round
_IDEMPOTENT_OPS = ("hello", "stats")


class ServeError(RuntimeError):
    """A request the server answered with ``ok: false``; the full decoded
    response rides on ``.response`` (``round_desync`` → ``expected``)."""

    def __init__(self, code: str, message: str = "", response: Optional[dict] = None):
        super().__init__(f"{code}: {message}" if message else code)
        self.code = code
        self.response = response or {}


class ServeClient:
    """``ServeClient(host, port)`` or ``ServeClient.connect(server.address)``.

    ``retries=N`` turns on the retry loop for idempotent requests (N
    reconnect-and-resend attempts after the first, exponential backoff
    starting at ``backoff`` seconds, capped at ``backoff_cap``, jittered by
    a generator seeded with ``seed`` so tests are reproducible).
    """

    def __init__(
        self,
        host: str,
        port: int,
        timeout: Optional[float] = 120.0,
        *,
        retries: int = 0,
        backoff: float = 0.02,
        backoff_cap: float = 1.0,
        seed: int = 0,
    ):
        self._addr = (host, int(port))
        self._timeout = timeout
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self._rng = random.Random(seed)
        self.rounds: Dict[int, int] = {}  # job uid -> next round to request
        self.sock: Optional[socket.socket] = None
        self._connect()

    @classmethod
    def connect(cls, address, timeout: Optional[float] = 120.0, **kw) -> "ServeClient":
        host, port = address
        return cls(host, port, timeout=timeout, **kw)

    # -- connection management --------------------------------------------

    def _connect(self) -> None:
        self.sock = socket.create_connection(self._addr, timeout=self._timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _break(self) -> None:
        """Mark the connection broken: a transport error mid-frame leaves
        the stream position unknown, so the socket must not be reused."""
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def _sleep(self, attempt: int) -> None:
        delay = min(self.backoff_cap, self.backoff * (2 ** attempt))
        time.sleep(delay * (0.5 + self._rng.random()))  # jitter in [0.5x, 1.5x)

    @staticmethod
    def _retryable(req: dict) -> bool:
        op = req.get("op")
        return op in _IDEMPOTENT_OPS or (op == "tick" and "round" in req)

    # -- the wire ----------------------------------------------------------

    def call(self, **req) -> dict:
        """One request → response round trip; raises ``ServeError`` on
        ``ok: false``.  With ``retries`` set, idempotent requests (see
        module docstring) survive dropped connections and server ``retry``
        answers by reconnecting and resending with backoff."""
        attempts = 1 + (self.retries if self._retryable(req) else 0)
        last: Exception = RuntimeError("unreachable")
        for attempt in range(attempts):
            if attempt:
                self._sleep(attempt - 1)
            try:
                if self.sock is None:
                    self._connect()
                protocol.send_message(self.sock, req)
                resp = protocol.recv_message(self.sock)
            except (protocol.ProtocolError, OSError) as e:
                self._break()
                last = e
                continue
            if not resp.get("ok"):
                code = resp.get("error", "unknown")
                if code == "retry" and attempt + 1 < attempts:
                    last = ServeError(code, resp.get("message", ""), resp)
                    continue
                raise ServeError(code, resp.get("message", ""), resp)
            return resp
        raise last

    # -- op helpers --------------------------------------------------------

    def hello(self) -> dict:
        return self.call(op="hello")

    def admit(self, **spec) -> int:
        """Admit a job (``JobSpec`` fields: K, k, rounds, sigma_frac, eta,
        quota, seed); returns the job uid all later ops use."""
        uid = self.call(op="admit", spec=spec)["job"]
        self.rounds[uid] = 0
        return uid

    def tick(self, job: int, x=None, bits=None, lags=None, round: Optional[int] = None) -> dict:
        """Post one round of feedback, get the next cohort:
        ``{"round", "cohort", "on_time", "stale"}``.  The request carries a
        round number — ``round`` if given, else the tracked cursor for jobs
        this client admitted — which makes it idempotent (and retryable)
        server-side.  On success the cursor advances past the served round."""
        req = {"op": "tick", "job": job}
        r = round if round is not None else self.rounds.get(job)
        if r is not None:
            req["round"] = int(r)
        if bits is not None:
            req["xb"] = protocol.encode_bits(bits)
        elif lags is not None:
            req["xl"] = protocol.encode_lags(lags)
        elif x is not None:
            req["x"] = [int(v) for v in x]
        resp = self.call(**req)
        if job in self.rounds:
            self.rounds[job] = int(resp["round"]) + 1
        return resp

    def retire(self, job: int) -> None:
        self.call(op="retire", job=job)
        self.rounds.pop(job, None)

    def stats(self) -> dict:
        return self.call(op="stats")

    def checkpoint(self) -> str:
        """Force a server checkpoint; returns the stem path."""
        return self.call(op="checkpoint")["path"]

    def shutdown(self) -> dict:
        """Ask the server to drain and stop (graceful)."""
        return self.call(op="shutdown")

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
