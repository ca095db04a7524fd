"""The port's TCP chaos proxy against the JAX package's
(tests/test_netchaos.py's twin): forwarding, one and several
connections, the RST cut, partitions (both ways and one way) and their
heal, truncation, corruption, latency, accept-but-dark during a
partition, and stop.

Each scenario runs once per package (``run_both``), the package's
``ChaosProxy`` (seed 7) in front of a fresh echo server, and returns the
bytes each side saw, the outcome class of each read (data, timeout,
reset) and the proxy's connection counts; the reference's invariants,
its latency bound included, are asserted on the way. Tolerance: exact.
"""

from __future__ import annotations

import contextlib
import socket
import threading
import time

import pytest
import torch

from tests.torch_operator import JAX_ROOT, PORT_ROOT, run_both, twin

torch.set_num_threads(1)


class EchoServer:
    """Accepts connections and echoes every byte back."""

    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.host, self.port = self.sock.getsockname()[:2]
        self._stop = threading.Event()
        self._conns = []
        self._lock = threading.Lock()
        self.received = b""
        threading.Thread(target=self._loop, daemon=True,
                         name="echo-server").start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._echo, args=(conn,), daemon=True,
                             name="echo-conn").start()

    def _echo(self, conn):
        try:
            while True:
                data = conn.recv(65536)
                if not data:
                    return
                with self._lock:
                    self.received += data
                conn.sendall(data)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass


@contextlib.contextmanager
def world(tw, seed=7):
    echo = EchoServer()
    proxy = tw.netchaos.ChaosProxy(echo.host, echo.port, seed=seed)
    try:
        yield echo, proxy
    finally:
        proxy.stop()
        echo.close()


def _dial(proxy):
    sock = socket.create_connection((proxy.host, proxy.port), timeout=5.0)
    sock.settimeout(5.0)
    return sock


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def _counted(proxy, n, timeout=5.0):
    """``proxy.connections()`` once it reaches ``n`` or the time runs out.
    A proxied connection pumps bytes before the accept loop lists it
    (``_ProxyConn`` starts its pumps, then the loop appends it), so an
    echo can come back before its connection is counted."""
    deadline = time.monotonic() + timeout
    while proxy.connections() != n and time.monotonic() < deadline:
        time.sleep(0.005)
    return proxy.connections()


def _expect_reset(sock):
    """Read until the peer's RST surfaces; a clean FIN fails."""
    with pytest.raises(OSError):
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if not sock.recv(4096):
                raise AssertionError("clean FIN, expected RST")
    return "reset"


def _expect_dark(sock, timeout=0.5):
    sock.settimeout(timeout)
    with pytest.raises(socket.timeout):
        sock.recv(4096)
    return "dark"


def bytes_round_trip_through_the_proxy(tw):
    with world(tw) as (echo, proxy):
        sock = _dial(proxy)
        try:
            sock.sendall(b"hello-chaos")
            got = _recv_exact(sock, 11)
            assert got == b"hello-chaos" and _counted(proxy, 1) == 1
            return got, proxy.connections()
        finally:
            sock.close()


def multiple_concurrent_connections(tw):
    with world(tw) as (echo, proxy):
        socks = [_dial(proxy) for _ in range(3)]
        try:
            for i, s in enumerate(socks):
                s.sendall(f"conn-{i}".encode())
            got = [_recv_exact(s, 6) for s in socks]
            assert got == [f"conn-{i}".encode() for i in range(3)]
            assert _counted(proxy, 3) == 3
            return got, proxy.connections()
        finally:
            for s in socks:
                s.close()


def cut_rsts_live_connections(tw):
    with world(tw) as (echo, proxy):
        sock = _dial(proxy)
        try:
            sock.sendall(b"ping")
            got = _recv_exact(sock, 4)
            assert got == b"ping"
            proxy.cut()
            return got, _expect_reset(sock)
        finally:
            sock.close()


def partition_goes_dark_and_heals(tw):
    with world(tw) as (echo, proxy):
        sock = _dial(proxy)
        try:
            sock.sendall(b"pre")
            pre = _recv_exact(sock, 3)
            assert pre == b"pre"
            proxy.partition(tw.netchaos.BOTH)
            time.sleep(0.1)
            sock.sendall(b"lost")
            dark = _expect_dark(sock)
            proxy.heal()
            sock.settimeout(5.0)
            sock.sendall(b"back")
            healed = _recv_exact(sock, 8)
            assert healed == b"lostback"
            return pre, dark, healed
        finally:
            sock.close()


def asymmetric_partition_s2c_requests_land_responses_dark(tw):
    with world(tw) as (echo, proxy):
        sock = _dial(proxy)
        try:
            proxy.partition(tw.netchaos.S2C)
            time.sleep(0.1)
            sock.sendall(b"oneway")
            deadline = time.monotonic() + 5
            dark = _expect_dark(sock)
            assert time.monotonic() < deadline
            # The echo server did receive it: c2s is clear.
            while echo.received != b"oneway" and time.monotonic() < deadline:
                time.sleep(0.02)
            return dark, echo.received
        finally:
            sock.close()


def truncate_next_forwards_n_bytes_then_rsts(tw):
    with world(tw) as (echo, proxy):
        sock = _dial(proxy)
        try:
            sock.sendall(b"warmup")
            assert _recv_exact(sock, 6) == b"warmup"
            proxy.truncate_next(4, direction=tw.netchaos.C2S)
            sock.sendall(b"abcdefgh")
            reset = _expect_reset(sock)
            deadline = time.monotonic() + 5
            while (echo.received != b"warmupabcd"
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert echo.received == b"warmupabcd"
            return reset, echo.received
        finally:
            sock.close()


def corrupt_next_xors_the_next_four_bytes(tw):
    with world(tw) as (echo, proxy):
        sock = _dial(proxy)
        try:
            proxy.corrupt_next(direction=tw.netchaos.C2S)
            sock.sendall(b"\x00\x00\x00\x01Z")
            got = _recv_exact(sock, 5)
            assert got == b"\xff\xff\xff\xfeZ"
            sock.sendall(b"clean")
            clean = _recv_exact(sock, 5)
            assert clean == b"clean"
            return got, clean
        finally:
            sock.close()


def latency_delays_forwarding(tw):
    with world(tw) as (echo, proxy):
        sock = _dial(proxy)
        try:
            proxy.latency(0.3, direction=tw.netchaos.BOTH)
            t0 = time.monotonic()
            sock.sendall(b"slow")
            got = _recv_exact(sock, 4)
            assert got == b"slow"
            assert time.monotonic() - t0 >= 0.5
            proxy.latency(0.0)
            return got
        finally:
            sock.close()


def new_connections_during_partition_are_accepted_not_refused(tw):
    with world(tw) as (echo, proxy):
        proxy.partition(tw.netchaos.BOTH)
        try:
            sock = socket.create_connection((proxy.host, proxy.port),
                                            timeout=2.0)
            sock.sendall(b"into-the-void")
            dark = _expect_dark(sock)
            sock.close()
            return "accepted", dark
        finally:
            proxy.heal()


def stop_closes_listener_and_connections(tw):
    echo = EchoServer()
    try:
        p = tw.netchaos.ChaosProxy(echo.host, echo.port, seed=1)
        sock = _dial(p)
        sock.sendall(b"x")
        got = _recv_exact(sock, 1)
        assert got == b"x"
        p.stop()
        # EOF or a reset, never a silent hang.
        try:
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if not sock.recv(4096):
                    break
            else:
                pytest.fail("connection survived proxy stop")
        except OSError:
            pass
        assert p.connections() == 0
        sock.close()
        return got, p.connections()
    finally:
        echo.close()


SCENARIOS = [
    bytes_round_trip_through_the_proxy,
    multiple_concurrent_connections,
    cut_rsts_live_connections,
    partition_goes_dark_and_heals,
    asymmetric_partition_s2c_requests_land_responses_dark,
    truncate_next_forwards_n_bytes_then_rsts,
    corrupt_next_xors_the_next_four_bytes,
    latency_delays_forwarding,
    new_connections_during_partition_are_accepted_not_refused,
    stop_closes_listener_and_connections,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


def test_directions_and_seeded_jitter_match_jax():
    """The fault vocabulary is the same, and a seeded proxy draws the same
    jitter sequence in both packages (soaks replay deterministically)."""
    jax, port = twin(JAX_ROOT), twin(PORT_ROOT)
    for name in ("C2S", "S2C", "BOTH"):
        assert getattr(port.netchaos, name) == getattr(jax.netchaos, name)
    draws = []
    for tw in (jax, port):
        echo = EchoServer()
        proxy = tw.netchaos.ChaosProxy(echo.host, echo.port, seed=11)
        try:
            draws.append([proxy._rand.random() for _ in range(8)])
        finally:
            proxy.stop()
            echo.close()
    assert draws[0] == draws[1]
