"""TCP-level chaos proxy — wire faults the verb-layer chaos can't model
(port of ``tpu_composer/sim/netchaos.py``).

ChaosStore and ChaosFabricProvider inject at the VERB layer: a call fails,
a call is slow, a watch drops. But the failure class that dominates tight
RPC paths in production (Dagger, PAPERS.md 2106.01482) lives a layer
down — half-open sockets, NAT table drops, asymmetric routing, slow-loris
peers — where the OS never tells anyone the peer is gone and every verb
ever sent is simply ambiguous. A replica killed with ``kill -9`` has its
sockets closed by the kernel; this proxy makes the network itself lie.

:class:`ChaosProxy` is a real listening socket interposed between one
replica and the sim apiserver (the replica's ``KubeConfig`` points at
it), with per-connection pump threads and scriptable faults:

- ``cut()`` — hard RST on every live connection (SO_LINGER 0).
- ``partition(direction)`` — silent drop: the pump stops READING its
  source for the dark direction(s), so bytes vanish from the receiver's
  view while the sender's kernel buffer backs up and eventually its
  ``send`` blocks — exactly the half-open stall the mux send-timeout and
  ping deadline exist for. ``"c2s"``/``"s2c"``/``"both"``; new
  connections during a partition are accepted-but-dark (half-open), never
  connection-refused — refusal is a FAST failure and would let the client
  cheat.
- ``heal()`` — clear partitions/stalls (latency and throttle persist
  until cleared explicitly; they model link quality, not outage).
- ``latency(seconds, jitter, direction)`` — per-direction added delay.
- ``throttle(direction, bytes_per_s)`` — slow-loris: dribble bytes.
- ``truncate_next(n, direction)`` — forward exactly ``n`` more bytes,
  then RST: a frame cut mid-body.
- ``corrupt_next(direction)`` — XOR the next 4 bytes forwarded: a
  corrupt length prefix (the 64MB frame-cap guard's reason to exist).

All timing uses ``time.monotonic``; jitter comes from a seeded
``random.Random`` so soaks replay deterministically.
"""

from __future__ import annotations

import logging
import random
import select
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

log = logging.getLogger("netchaos")

#: Forwarding directions.
C2S = "c2s"  # client -> server (replica -> apiserver)
S2C = "s2c"  # server -> client (apiserver -> replica)
BOTH = "both"

_LINGER_RST = struct.pack("ii", 1, 0)

#: Pump wakeup quantum: fault flips (partition/heal) take effect within
#: this bound even on an otherwise idle direction.
_TICK = 0.05


def _rst(sock: socket.socket) -> None:
    """Close with RST instead of FIN — the 'hard cut' fault."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, _LINGER_RST)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class _DirState:
    """Fault state for one forwarding direction of one proxy."""

    def __init__(self) -> None:
        self.dark = False
        self.latency = 0.0
        self.jitter = 0.0
        self.throttle_bps = 0.0
        self.truncate_after: Optional[int] = None
        self.corrupt_next = False


class _ProxyConn:
    """One proxied TCP connection: client socket, server socket, 2 pumps."""

    _ids = 0

    def __init__(self, proxy: "ChaosProxy", client: socket.socket,
                 server: socket.socket) -> None:
        self.proxy = proxy
        self.client = client
        self.server = server
        self.closed = threading.Event()
        _ProxyConn._ids += 1
        cid = _ProxyConn._ids
        self._threads = [
            threading.Thread(
                target=self._pump, args=(client, server, C2S),
                daemon=True, name=f"netchaos-c2s-{cid}",
            ),
            threading.Thread(
                target=self._pump, args=(server, client, S2C),
                daemon=True, name=f"netchaos-s2c-{cid}",
            ),
        ]
        for t in self._threads:
            t.start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              direction: str) -> None:
        proxy = self.proxy
        while not self.closed.is_set():
            state = proxy._dirs[direction]
            # Dark check BEFORE the read: a partitioned direction must not
            # drain its source — the sender's kernel buffer fills and its
            # send() eventually blocks, which is what a real half-open
            # stall does (and what the mux send-timeout must survive).
            if state.dark:
                time.sleep(_TICK)
                continue
            try:
                readable, _, _ = select.select([src], [], [], _TICK)
            except (OSError, ValueError):
                break
            if not readable:
                continue
            try:
                data = src.recv(65536)
            except OSError:
                break
            if not data:
                break
            rst_after = False
            with proxy._lock:
                if state.dark:
                    # Partition raced the blocking read: the pump was parked
                    # in recv() when the direction went dark, so this chunk
                    # was read before the loop-top check could stop it.
                    # Silent-drop it rather than let one in-flight frame
                    # slip through the partition.
                    continue
                if state.corrupt_next:
                    state.corrupt_next = False
                    n = min(4, len(data))
                    data = bytes(b ^ 0xFF for b in data[:n]) + data[n:]
                if state.truncate_after is not None:
                    if len(data) >= state.truncate_after:
                        data = data[: state.truncate_after]
                        state.truncate_after = None
                        rst_after = True
                    else:
                        state.truncate_after -= len(data)
                delay = state.latency
                if state.jitter:
                    delay += proxy._rand.uniform(0.0, state.jitter)
                bps = state.throttle_bps
            if delay > 0:
                time.sleep(delay)
            try:
                if bps > 0:
                    # Slow-loris: dribble small chunks at the target rate.
                    chunk = max(1, int(bps * _TICK))
                    for off in range(0, len(data), chunk):
                        if self.closed.is_set():
                            return
                        dst.sendall(data[off: off + chunk])
                        time.sleep(_TICK)
                else:
                    dst.sendall(data)
            except OSError:
                break
            if rst_after:
                self.rst()
                return
        self.close()

    def rst(self) -> None:
        """Hard-cut this connection: RST both sides."""
        if not self.closed.is_set():
            self.closed.set()
            _rst(self.client)
            _rst(self.server)

    def close(self) -> None:
        if not self.closed.is_set():
            self.closed.set()
            for sock in (self.client, self.server):
                try:
                    sock.close()
                except OSError:
                    pass


class ChaosProxy:
    """Scriptable TCP fault injector between one client and one server.

    Listens on an ephemeral 127.0.0.1 port; every accepted connection is
    pumped to ``(target_host, target_port)`` through the fault state.
    Point a replica's kubeconfig ``server:`` at :attr:`url` and drive the
    faults from the test/fleet supervisor.
    """

    def __init__(self, target_host: str, target_port: int,
                 listen_host: str = "127.0.0.1", seed: int = 0) -> None:
        self.target = (target_host, target_port)
        self._lock = threading.Lock()
        self._dirs: Dict[str, _DirState] = {C2S: _DirState(), S2C: _DirState()}
        self._conns: List[_ProxyConn] = []
        self._rand = random.Random(seed)
        self._stopped = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, 0))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accepter = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"netchaos-accept-{self.port}",
        )
        self._accepter.start()

    # -- wiring --------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                return  # listener closed by stop()
            try:
                client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            # Dial the real server even mid-partition: a refused connect
            # is a fast, honest failure — a partition must present as
            # accepted-but-dark (half-open) instead.
            try:
                server = socket.create_connection(self.target, timeout=5.0)
                server.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                client.close()
                continue
            conn = _ProxyConn(self, client, server)
            with self._lock:
                self._conns = [c for c in self._conns
                               if not c.closed.is_set()]
                self._conns.append(conn)

    def connections(self) -> int:
        with self._lock:
            return sum(1 for c in self._conns if not c.closed.is_set())

    # -- faults --------------------------------------------------------
    def _targets(self, direction: str) -> List[_DirState]:
        if direction == BOTH:
            return [self._dirs[C2S], self._dirs[S2C]]
        return [self._dirs[direction]]

    def cut(self) -> None:
        """RST every live proxied connection right now."""
        with self._lock:
            conns = list(self._conns)
        log.info("netchaos %s: cut (%d conns)", self.port, len(conns))
        for c in conns:
            c.rst()

    def partition(self, direction: str = BOTH) -> None:
        """Silent drop on ``direction`` — bytes vanish, sockets stay."""
        log.info("netchaos %s: partition %s", self.port, direction)
        with self._lock:
            for st in self._targets(direction):
                st.dark = True

    def heal(self) -> None:
        """End partitions/stalls and pending truncations/corruptions."""
        log.info("netchaos %s: heal", self.port)
        with self._lock:
            for st in self._dirs.values():
                st.dark = False
                st.truncate_after = None
                st.corrupt_next = False

    def latency(self, seconds: float, jitter: float = 0.0,
                direction: str = BOTH) -> None:
        """Add forwarding delay (seeded jitter on top) to ``direction``."""
        with self._lock:
            for st in self._targets(direction):
                st.latency = max(0.0, seconds)
                st.jitter = max(0.0, jitter)

    def throttle(self, direction: str = BOTH,
                 bytes_per_s: float = 0.0) -> None:
        """Slow-loris ``direction`` to ``bytes_per_s`` (0 = unthrottled)."""
        with self._lock:
            for st in self._targets(direction):
                st.throttle_bps = max(0.0, bytes_per_s)

    def truncate_next(self, n: int, direction: str = C2S) -> None:
        """Forward exactly ``n`` more bytes on ``direction``, then RST —
        a frame cut mid-body."""
        with self._lock:
            for st in self._targets(direction):
                st.truncate_after = max(0, int(n))

    def corrupt_next(self, direction: str = S2C) -> None:
        """XOR the next 4 bytes forwarded on ``direction`` — a corrupt
        frame length prefix."""
        with self._lock:
            for st in self._targets(direction):
                st.corrupt_next = True

    # -- lifecycle -----------------------------------------------------
    def stop(self) -> None:
        self._stopped.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            self._conns = []
        for c in conns:
            c.close()

    close = stop
