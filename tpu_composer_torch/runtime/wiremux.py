"""Multiplexed framed wire transport — the v2 store wire plane (port of
``tpu_composer/runtime/wiremux.py``; its frames are byte-identical, so
either package's client talks to either package's server).

One persistent socket per (client, apiserver) pair carries every verb and
every watch concurrently: length-prefixed JSON frames with correlation ids,
pipelined from all controller threads, with watch events arriving as
server-push frames on the same connection. This is the Dagger/RPCAcc lesson
(PAPERS.md): per-request HTTP overhead — request lines, header parsing, a
server thread handoff per verb, and one dedicated socket per watch —
dominates tight RPC paths; a framed mux amortizes all of it over a single
connection.

Protocol (version ``tpuc-mux/1``):

- Handshake: a plain HTTP/1.1 ``GET /mux`` with ``Upgrade: tpuc-mux/1``;
  the server answers ``101 Switching Protocols`` and both sides switch to
  framed mode on the same socket. A server that answers anything else does
  not speak mux — the client falls back to HTTP permanently.
- Frames: 4-byte big-endian unsigned length, then that many bytes of UTF-8
  JSON. Hard cap ``MAX_FRAME`` guards against corrupt prefixes.
- Client → server:
    ``{"id": N, "method": "GET|POST|PUT|DELETE", "path": ..., "body": ...}``
      one verb; a path carrying ``watch=true`` opens a watch stream whose
      stream id IS the request id.
    ``{"cancel": N}`` — stop watch stream N.
    ``{"ping": N}`` — liveness probe (client-initiated, answered inline).
- Server → client:
    ``{"id": N, "code": C, "body": {...}}`` — verb response (or the watch
      accept/denial: a watch ack carries ``"watch": true``).
    ``{"watch": N, "event": {...}}`` — one watch event (same JSON the HTTP
      chunked watch writes per line, including the 410 ERROR persona).
    ``{"watch": N, "end": true}`` — stream N ended server-side.
    ``{"pong": N}`` — answer to ping N.

Liveness: after the handshake the socket is fully blocking, so a silent
partition (NAT drop, half-open peer) would otherwise stall every pending
correlation id until its individual request timeout and leave watches
waiting out their idle period. With ``ping_period > 0`` the client probes
the transport with ping frames; a pong outstanding past
``ping_misses x ping_period`` declares the connection dead and fails ALL
pending verbs and watch streams at once — detection within ~2x the ping
period at ``ping_misses=1``, versus the ~30s per-request timeout baseline.
Sends carry their own wall deadline (``send_timeout``) so a peer that
stops draining the socket can never wedge a controller thread inside a
blocking ``sendall``. Reconnects back off (bounded) and fail fast while
the backoff window is open.

Method/path/body are byte-identical to the HTTP path, so everything keyed
on them — the sim apiserver's request_log assertions, fail-hook personas,
``watch_blocker``'s ``"watch=true" in path`` match — behaves the same with
the mux on or off. ``TPUC_WIRE_MUX=0`` disables the client entirely and
the keep-alive HTTP path runs untouched.
"""

from __future__ import annotations

import itertools
import json
import logging
import queue
import select
import socket
import ssl
import struct
import threading
import time
import urllib.parse
from typing import Any, Callable, Dict, Optional, Tuple

from tpu_composer_torch.runtime.metrics import (
    wire_mux_reconnects_total,
    wire_ping_rtt_seconds,
)

log = logging.getLogger("wiremux")

#: Protocol token in the Upgrade header; bump on incompatible frame changes.
PROTOCOL = "tpuc-mux/1"

#: Upgrade endpoint path on the apiserver.
MUX_PATH = "/mux"

#: Refuse frames larger than this — a corrupt length prefix must not make
#: us try to allocate gigabytes.
MAX_FRAME = 64 * 1024 * 1024

#: Per-write chunk on TLS connections, where MSG_DONTWAIT is unavailable
#: (``ssl.SSLSocket.send`` rejects flags): small enough that one blocking
#: SSL_write of a chunk-sized record drains quickly even against a nearly
#: full socket buffer, so the deadline loop in ``_send_bytes`` keeps
#: control between chunks.
TLS_SEND_CHUNK = 4096

_LEN = struct.Struct(">I")


class MuxError(Exception):
    """Transport-level mux failure (connect, send, connection died)."""


class MuxUnsupported(MuxError):
    """The server rejected the /mux upgrade: fall back to HTTP for good."""


class MuxHTTPError(MuxError):
    """An API error response frame (code >= 400); carries the Status body."""

    def __init__(self, code: int, body: Any) -> None:
        super().__init__(f"HTTP {code}")
        self.code = code
        self.body = body if isinstance(body, dict) else {"message": str(body)}


# ----------------------------------------------------------------------
# frame codec (shared by client and the sim apiserver's mux endpoint)
# ----------------------------------------------------------------------
def encode_frame(obj: Dict[str, Any]) -> bytes:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    return _LEN.pack(len(payload)) + payload


def read_exact(fp, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes from a file-like object, riding out partial
    reads across frame boundaries. None on clean EOF at a frame boundary;
    MuxError on EOF mid-frame (truncated peer)."""
    chunks = []
    got = 0
    while got < n:
        chunk = fp.read(n - got)
        if not chunk:
            if got == 0:
                return None
            raise MuxError(f"truncated frame: wanted {n} bytes, got {got}")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(fp) -> Optional[Dict[str, Any]]:
    """One frame off a blocking file-like object; None on clean EOF."""
    head = read_exact(fp, _LEN.size)
    if head is None:
        return None
    (size,) = _LEN.unpack(head)
    if size > MAX_FRAME:
        raise MuxError(f"frame of {size} bytes exceeds cap {MAX_FRAME}")
    body = read_exact(fp, size)
    if body is None:
        raise MuxError("EOF between frame header and body")
    try:
        obj = json.loads(body)
    except ValueError as e:
        raise MuxError(f"corrupt frame payload: {e}") from None
    if not isinstance(obj, dict):
        raise MuxError(f"frame payload is {type(obj).__name__}, not an object")
    return obj


# ----------------------------------------------------------------------
# client
# ----------------------------------------------------------------------
class _Pending:
    """One in-flight verb awaiting its response frame."""

    __slots__ = ("event", "code", "body", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.code: Optional[int] = None
        self.body: Any = None
        self.error: Optional[MuxError] = None


class MuxWatch:
    """One watch stream riding the mux connection.

    Iterates JSON-line byte strings — the exact shape ``urllib``'s chunked
    watch response yields line by line — so ``_WatchThread`` consumes both
    transports through one loop. ``shutdown()`` mirrors the raw-socket
    shutdown the HTTP path uses to unblock a reader from another thread.
    """

    _END = object()

    def __init__(self, conn: "_MuxConn", stream_id: int, timeout: float) -> None:
        self._conn = conn
        self._id = stream_id
        self._timeout = timeout
        self._events: "queue.Queue[Any]" = queue.Queue()
        self._closed = False

    # fed by the connection reader thread
    def _push(self, event: Dict[str, Any]) -> None:
        self._events.put(event)

    def _end(self) -> None:
        self._events.put(self._END)

    def _fail(self, err: MuxError) -> None:
        """Connection death: the consumer must learn NOW, and must be able
        to tell this apart from a clean server-side stream end — a clean
        end means "re-list maybe", a dead connection means "reconnect with
        the resume cursor immediately"."""
        self._events.put(err)

    def __iter__(self) -> "MuxWatch":
        return self

    def __next__(self) -> bytes:
        if self._closed:
            raise StopIteration
        try:
            # The per-event timeout doubles as the liveness check, exactly
            # like the HTTP watch's socket timeout: a quiet stream raises
            # and the watch thread reconnects from its resume cursor.
            item = self._events.get(timeout=self._timeout)
        except queue.Empty:
            raise socket.timeout(f"mux watch {self._id}: idle") from None
        if item is self._END:
            self._closed = True
            raise StopIteration
        if isinstance(item, MuxError):
            self._closed = True
            raise MuxError(f"mux watch {self._id}: connection died: {item}")
        return (json.dumps(item) + "\n").encode()

    def shutdown(self) -> None:
        """Stop the stream from another thread: best-effort cancel to the
        server, then a local end marker so a blocked __next__ returns."""
        self._conn.cancel_watch(self._id)
        self._end()

    close = shutdown


class _MuxConn:
    """One live framed connection: socket, reader thread, pinger thread,
    correlation maps."""

    def __init__(
        self,
        sock: socket.socket,
        ping_period: float = 0.0,
        ping_misses: int = 2,
        send_timeout: float = 10.0,
        on_dead: Optional[Callable[["_MuxConn"], None]] = None,
        on_alive: Optional[Callable[["_MuxConn"], None]] = None,
    ) -> None:
        self.sock = sock
        self.rfile = sock.makefile("rb")
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: Dict[int, _Pending] = {}
        self._watches: Dict[int, MuxWatch] = {}
        self.dead = threading.Event()
        self._send_timeout = max(0.1, send_timeout)
        self._ping_period = max(0.0, ping_period)
        self._ping_misses = max(1, int(ping_misses))
        self._ping_sent: Dict[int, float] = {}  # seq -> monotonic send time
        self._ping_seq = 0
        self._last_ping = time.monotonic()
        #: Monotonic time of the last frame of ANY kind from the peer —
        #: the liveness clock. Any arriving frame proves the wire, so a
        #: busy connection never false-positives on one slow pong.
        self._last_frame = time.monotonic()
        #: True once any frame arrived on this connection — a connection
        #: that dies frameless counts toward the client's fail streak.
        self.got_frame = False
        self._on_dead = on_dead
        self._on_alive = on_alive
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="mux-reader"
        )
        self._reader.start()
        if self._ping_period > 0:
            self._pinger = threading.Thread(
                target=self._ping_loop, daemon=True, name="mux-pinger"
            )
            self._pinger.start()

    # -- sending -------------------------------------------------------
    def send(self, frame: Dict[str, Any]) -> None:
        data = encode_frame(frame)
        try:
            with self._wlock:
                self._send_bytes(data)
        except MuxError as e:
            self._fail(e)
            raise
        except OSError as e:
            err = MuxError(f"mux send: {e}")
            self._fail(err)
            raise err from None

    def _send_bytes(self, data: bytes) -> None:
        """sendall under a wall deadline: wait-for-writable + partial send,
        so a peer that stops draining (full TCP buffer, half-open stall)
        fails the connection after ``send_timeout`` instead of wedging the
        calling controller thread inside a blocking ``sendall`` forever.
        Never uses ``settimeout`` — the reader thread shares this socket
        and a timeout surfacing mid-read would corrupt framing."""
        deadline = time.monotonic() + self._send_timeout
        view = memoryview(data)
        sent = 0
        # ssl.SSLSocket.send() raises ValueError for ANY non-zero flags, so
        # the MSG_DONTWAIT trick below is plain-TCP only. TLS instead
        # writes one small record per select-writable wakeup: a blocking
        # SSL_write of a TLS_SEND_CHUNK record parks at most until the
        # kernel drains that one record (not the whole frame), and the
        # deadline check between chunks still bounds total elapsed time —
        # a slightly softer bound than MSG_DONTWAIT's, accepted because
        # O_NONBLOCK/settimeout can't be flipped on the fd the blocking
        # reader thread shares.
        tls = isinstance(self.sock, ssl.SSLSocket)
        while sent < len(view):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise MuxError(
                    f"mux send: peer stalled for {self._send_timeout}s"
                    " with socket buffer full"
                )
            try:
                _, writable, _ = select.select(
                    [], [self.sock], [], min(remaining, 0.25)
                )
            except (OSError, ValueError):
                raise MuxError("mux send: socket closed") from None
            if not writable:
                continue
            try:
                if tls:
                    sent += self.sock.send(view[sent:sent + TLS_SEND_CHUNK])
                else:
                    # MSG_DONTWAIT: non-blocking for THIS call only,
                    # without flipping O_NONBLOCK on the shared fd. A plain
                    # send() on a blocking socket queues the ENTIRE buffer
                    # before returning — against a stalled peer a large
                    # frame wedges forever no matter what select said
                    # (select only guarantees SOME space, not len(view)
                    # of it).
                    sent += self.sock.send(view[sent:], socket.MSG_DONTWAIT)
            except (BlockingIOError, InterruptedError,
                    ssl.SSLWantWriteError, ssl.SSLWantReadError):
                continue
            except ValueError as e:
                # Safety net: a socket variant that rejects flags (or an
                # operation on a torn-down SSL object) must fail the
                # connection as a classified MuxError — never escape as an
                # unhandled ValueError that would kill the calling
                # controller thread unclassified.
                raise MuxError(f"mux send: {e}") from None

    # -- liveness ------------------------------------------------------
    def _ping_loop(self) -> None:
        """Probe the transport with ping frames every ``ping_period``; the
        connection is declared dead when NO frame of any kind (pong,
        response, watch event) has arrived for ``(misses + 0.5) x period``
        while a probe is outstanding. On a healthy idle wire the frame age
        oscillates between ~0 and one period (each probe's pong resets
        it), so the extra half period is the margin that keeps the
        threshold strictly above the probe cadence. Wakes at
        quarter-period granularity; worst-case detection from stall onset
        is ``(misses + 0.75) x period`` — two periods at the bench's
        ``misses=1``, comfortably under any per-request timeout."""
        period = self._ping_period
        deadline = (self._ping_misses + 0.5) * period
        err: Optional[MuxError] = None
        while not self.dead.wait(period / 4.0):
            now = time.monotonic()
            with self._lock:
                stale_for = now - self._last_frame
                if self._ping_sent and stale_for >= deadline:
                    err = MuxError(
                        f"mux liveness: no frame for {stale_for:.2f}s with"
                        f" {len(self._ping_sent)} ping(s) unanswered"
                        f" (deadline {deadline:g}s ="
                        f" (misses {self._ping_misses} + 0.5) x {period:g}s)"
                    )
                    break
                if now - self._last_ping < period:
                    continue
                self._ping_seq += 1
                seq = self._ping_seq
                self._ping_sent[seq] = now
                self._last_ping = now
            try:
                self.send({"ping": seq})
            except MuxError:
                return  # send() already failed the connection
        if err is not None:
            self._fail(err)

    def cancel_watch(self, stream_id: int) -> None:
        with self._lock:
            self._watches.pop(stream_id, None)
        if not self.dead.is_set():
            try:
                self.send({"cancel": stream_id})
            except MuxError:
                pass

    # -- registration --------------------------------------------------
    def add_pending(self, rid: int) -> _Pending:
        p = _Pending()
        with self._lock:
            if self.dead.is_set():
                raise MuxError("mux connection is down")
            self._pending[rid] = p
        return p

    def drop_pending(self, rid: int) -> None:
        with self._lock:
            self._pending.pop(rid, None)

    def add_watch(self, rid: int, w: MuxWatch) -> None:
        with self._lock:
            if self.dead.is_set():
                raise MuxError("mux connection is down")
            self._watches[rid] = w

    # -- reader --------------------------------------------------------
    def _read_loop(self) -> None:
        err: Optional[MuxError] = None
        try:
            while True:
                frame = read_frame(self.rfile)
                if frame is None:
                    err = MuxError("mux connection closed by server")
                    break
                self._dispatch(frame)
        except (MuxError, OSError, ValueError) as e:
            err = e if isinstance(e, MuxError) else MuxError(f"mux read: {e}")
        self._fail(err or MuxError("mux connection closed"))

    def _dispatch(self, frame: Dict[str, Any]) -> None:
        self._last_frame = time.monotonic()
        if not self.got_frame:
            self.got_frame = True
            if self._on_alive is not None:
                self._on_alive(self)
        if "pong" in frame:
            with self._lock:
                sent_at = self._ping_sent.pop(frame["pong"], None)
            if sent_at is not None:
                wire_ping_rtt_seconds.observe(time.monotonic() - sent_at)
            return
        if "watch" in frame and "id" not in frame:
            sid = frame["watch"]
            with self._lock:
                w = self._watches.get(sid)
                if frame.get("end"):
                    self._watches.pop(sid, None)
            if w is None:
                return
            if frame.get("end"):
                w._end()
            else:
                w._push(frame.get("event") or {})
            return
        rid = frame.get("id")
        with self._lock:
            p = self._pending.pop(rid, None)
        if p is None:
            return  # response to a request whose waiter timed out
        p.code = int(frame.get("code", 500))
        p.body = frame.get("body")
        p.event.set()

    def _fail(self, err: MuxError) -> None:
        """Connection is gone: everything in flight fails AT ONCE — every
        pending verb and every watch stream, not serially via per-request
        timeouts. Watch consumers get a distinguishable connection-death
        error so they reconnect from their resume cursor immediately."""
        with self._lock:
            if self.dead.is_set():
                return
            self.dead.set()
            pending = list(self._pending.values())
            self._pending.clear()
            watches = list(self._watches.values())
            self._watches.clear()
            self._ping_sent.clear()
        for p in pending:
            p.error = err
            p.event.set()
        for w in watches:
            w._fail(err)
        if self._on_dead is not None:
            self._on_dead(self)
        self.close()

    def close(self) -> None:
        self.dead.set()
        try:
            self.sock.close()
        except OSError:
            pass


class MuxClient:
    """Multiplexed apiserver client: one connection, many concurrent verbs
    and watches. Thread-safe; reconnects transparently on the next call
    after a connection loss (watch consumers re-open their own streams)."""

    def __init__(
        self,
        base_url: str,
        ssl_context: Optional[ssl.SSLContext] = None,
        token: Optional[str] = None,
        connect_timeout: float = 5.0,
        ping_period: float = 5.0,
        ping_misses: int = 2,
        send_timeout: float = 10.0,
        redial_backoff_max: float = 2.0,
    ) -> None:
        split = urllib.parse.urlsplit(base_url)
        self._host = split.hostname or "127.0.0.1"
        self._port = split.port or (443 if split.scheme == "https" else 80)
        self._tls = split.scheme == "https"
        self._ssl_ctx = ssl_context
        self._token = token
        self._connect_timeout = connect_timeout
        self._ping_period = max(0.0, ping_period)
        self._ping_misses = max(1, int(ping_misses))
        self._send_timeout = send_timeout
        self._redial_backoff_max = max(0.05, redial_backoff_max)
        self._ids = itertools.count(1)
        self._conn: Optional[_MuxConn] = None
        self._conn_lock = threading.Lock()
        self._closed = False
        self._backoff = 0.0
        self._next_dial = 0.0  # monotonic gate: fail fast while it's open
        self._dialed_once = False
        #: Consecutive connection-level failures (failed handshakes plus
        #: connections that died before serving a single frame) — NEVER
        #: per-request failures. The kubestore's flap damper reads this.
        #: Mutated from the dialing thread (under ``_conn_lock``) AND from
        #: reader/pinger-thread death/alive callbacks, so every mutation
        #: takes ``_streak_lock`` — racing unlocked ``+=``/``= 0`` could
        #: lose an increment or a reset and delay (or falsely trip) the
        #: K-streak mux->HTTP demotion.
        self.fail_streak = 0
        self._streak_lock = threading.Lock()

    # -- connection management -----------------------------------------
    def _handshake(self) -> _MuxConn:
        try:
            sock = socket.create_connection(
                (self._host, self._port), timeout=self._connect_timeout
            )
        except OSError as e:
            raise MuxError(f"mux connect {self._host}:{self._port}: {e}") from None
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        try:
            if self._tls:
                ctx = self._ssl_ctx or ssl.create_default_context()
                sock = ctx.wrap_socket(sock, server_hostname=self._host)
            lines = [
                f"GET {MUX_PATH} HTTP/1.1",
                f"Host: {self._host}:{self._port}",
                f"Upgrade: {PROTOCOL}",
                "Connection: Upgrade",
            ]
            if self._token:
                lines.append(f"Authorization: Bearer {self._token}")
            sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
            # Read the HTTP response head byte-by-byte up to the blank line —
            # anything past it is the first frame and must stay in the stream.
            head = b""
            while b"\r\n\r\n" not in head:
                b1 = sock.recv(1)
                if not b1:
                    raise MuxError("mux handshake: connection closed")
                head += b1
                if len(head) > 65536:
                    raise MuxError("mux handshake: oversized response head")
            status = head.split(b"\r\n", 1)[0].decode(errors="replace")
            parts = status.split()
            if len(parts) < 2 or parts[1] != "101":
                raise MuxUnsupported(
                    f"server declined mux upgrade: {status!r}"
                )
        except MuxError:
            sock.close()
            raise
        except OSError as e:
            sock.close()
            raise MuxError(f"mux handshake: {e}") from None
        # Handshake done: clear the connect timeout — reads are framed and
        # blocking from here; per-request deadlines live client-side and
        # the ping deadline covers transport liveness.
        sock.settimeout(None)
        return _MuxConn(
            sock,
            ping_period=self._ping_period,
            ping_misses=self._ping_misses,
            send_timeout=self._send_timeout,
            on_dead=self._conn_died,
            on_alive=self._conn_alive,
        )

    def _conn_died(self, conn: "_MuxConn") -> None:
        # Reader/pinger-thread callback: a connection that never served a
        # frame is a connection-level failure episode.
        if not conn.got_frame:
            with self._streak_lock:
                self.fail_streak += 1

    def _conn_alive(self, conn: "_MuxConn") -> None:
        with self._streak_lock:
            self.fail_streak = 0

    def _ensure_conn(self) -> _MuxConn:
        conn = self._conn
        if conn is not None and not conn.dead.is_set():
            return conn
        with self._conn_lock:
            if self._closed:
                raise MuxError("mux client closed")
            conn = self._conn
            if conn is not None and not conn.dead.is_set():
                return conn
            now = time.monotonic()
            if now < self._next_dial:
                raise MuxError(
                    f"mux reconnect backoff: retry in"
                    f" {self._next_dial - now:.2f}s after"
                    f" {self.fail_streak} consecutive connection failures"
                )
            try:
                conn = self._handshake()
            except MuxUnsupported:
                raise  # permanent verdict, not a flap: no backoff/streak
            except MuxError:
                with self._streak_lock:
                    self.fail_streak += 1
                self._backoff = min(
                    max(self._backoff * 2.0, 0.05), self._redial_backoff_max
                )
                self._next_dial = time.monotonic() + self._backoff
                raise
            self._backoff = 0.0
            self._next_dial = 0.0
            if self._dialed_once:
                wire_mux_reconnects_total.inc()
                log.info(
                    "mux reconnected to %s:%s (watches resume from cache"
                    " cursor)", self._host, self._port,
                )
            self._dialed_once = True
            self._conn = conn
            return conn

    # -- verbs ---------------------------------------------------------
    def request(
        self,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
        timeout: float = 30.0,
        idempotent: bool = False,
    ) -> Tuple[int, Any]:
        """One pipelined verb. Returns (status code, decoded body).

        Retry classification: a failure BEFORE the frame left this process
        ("never sent" — dead pooled connection, registration on a dying
        connection) is safe to retry for ANY verb, the same recovery the
        keep-alive HTTP path does. A connection death WHILE the request is
        in flight is ambiguous — the server may or may not have executed
        the verb — so it is retried once only when the caller declares the
        verb ``idempotent`` (reads, CAS-guarded updates); otherwise it
        surfaces as MuxError so the caller's requeue + nonce machinery
        resolves the ambiguity. A response timeout always raises."""
        for attempt in (0, 1):
            conn = self._ensure_conn()
            rid = next(self._ids)
            try:
                pending = conn.add_pending(rid)
            except MuxError:
                if attempt == 0:
                    continue  # never sent: safe for any verb
                raise
            try:
                conn.send({"id": rid, "method": method, "path": path,
                           "body": body})
            except MuxError:
                conn.drop_pending(rid)
                if attempt == 0:
                    continue  # never sent: safe for any verb
                raise
            if not pending.event.wait(timeout):
                conn.drop_pending(rid)
                raise MuxError(f"{method} {path}: mux response timeout")
            if pending.error is not None:
                # In flight when the connection died: ambiguous.
                if idempotent and attempt == 0:
                    continue
                raise pending.error
            return pending.code or 500, pending.body
        raise MuxError(f"{method} {path}: mux retry fell through")

    def watch(self, path: str, timeout: float = 30.0) -> MuxWatch:
        """Open a watch stream (path carries ``watch=true`` + resume rv).
        Returns once the server acks; raises MuxHTTPError on denial (e.g.
        a fail-hook 503) so callers map it like an HTTP error status."""
        conn = self._ensure_conn()
        rid = next(self._ids)
        pending = conn.add_pending(rid)
        w = MuxWatch(conn, rid, timeout)
        conn.add_watch(rid, w)
        try:
            conn.send({"id": rid, "method": "GET", "path": path, "body": None})
        except MuxError:
            conn.drop_pending(rid)
            raise
        if not pending.event.wait(timeout):
            conn.drop_pending(rid)
            conn.cancel_watch(rid)
            raise MuxError(f"GET {path}: mux watch-open timeout")
        if pending.error is not None:
            raise pending.error
        if (pending.code or 500) >= 400:
            with conn._lock:
                conn._watches.pop(rid, None)
            raise MuxHTTPError(pending.code or 500, pending.body)
        return w

    def close(self) -> None:
        with self._conn_lock:
            self._closed = True
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()
