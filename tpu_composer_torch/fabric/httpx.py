"""Shared JSON-over-HTTP transport for the remote fabric backends.

Port of ``tpu_composer/fabric/httpx.py``: the same wire format, defaults,
error classes and metric names.

The reference duplicates an http.Client + bearer-auth + JSON envelope across
its four fabric clients (fti/cm/client.go:50-93, fti/fm/client.go:47-98,
nec/client.go:..., sunfish/client.go:...); here it is factored once. Every
remote provider (rest, layout, redfish) composes this transport.

Semantics:
- bearer auth from an optional TokenCache; a 401 invalidates the cached
  token and retries exactly once (the reference refetches on expiry only —
  retrying on 401 also heals server-side token revocation);
- responses are parsed as JSON when non-empty; HTTP errors carry the
  server's ``{"error": ...}`` message when present;
- the error taxonomy is applied HERE, once, for every backend: transport
  failures (connection reset, refused, DNS, socket timeout) and 5xx raise
  ``TransientFabricError``; 4xx raise terminal ``HttpStatusError`` — raw
  urllib exceptions never leak into reconcile loops;
- idempotent GETs absorb a bounded number of transient failures with
  decorrelated-jitter backoff before surfacing one (mutating verbs are
  NEVER retried here — the controllers' level-triggered requeue owns that,
  and a blind re-PUT could double-submit a non-idempotent pool op).
"""

from __future__ import annotations

import http.client
import json
import os
import random
import socket
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, Optional, Tuple

from tpu_composer_torch.fabric.provider import FabricError, TransientFabricError
from tpu_composer_torch.fabric.token import TokenCache
from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.metrics import fabric_retries_total

#: Env override for every remote backend's HTTP timeout (seconds). The
#: reference hardcodes per-client values (CM 60s, FM 180s, NEC 60s); one
#: knob beats three constructor plumbing paths when a fabric manager is
#: known-slow or a test wants sub-second failure detection.
TIMEOUT_ENV = "TPU_COMPOSER_FABRIC_TIMEOUT"


def fabric_timeout(default: float) -> float:
    """Resolve the HTTP timeout: $TPU_COMPOSER_FABRIC_TIMEOUT wins over the
    backend's reference-derived default; malformed values fall back."""
    raw = os.environ.get(TIMEOUT_ENV, "")
    if raw:
        try:
            val = float(raw)
            if val > 0:
                return val
        except ValueError:
            pass
    return default


class HttpStatusError(FabricError):
    """Non-2xx response from the fabric endpoint (terminal: 4xx)."""

    def __init__(self, code: int, message: str, body: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.code = code
        self.body = body or {}


class TransientHttpStatusError(HttpStatusError, TransientFabricError):
    """5xx — the endpoint is alive but failed server-side; retryable."""


def http_status_error(
    code: int, message: str, body: Optional[Dict[str, Any]] = None
) -> HttpStatusError:
    cls = TransientHttpStatusError if code >= 500 else HttpStatusError
    return cls(code, message, body)


class JsonHttpClient:
    def __init__(
        self,
        base_url: str,
        token_cache: Optional[TokenCache] = None,
        timeout: float = 60.0,
        get_retries: int = 2,
        retry_base: float = 0.05,
        retry_cap: float = 2.0,
        _sleep: Callable[[float], None] = time.sleep,
        _rng: Optional[random.Random] = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.token_cache = token_cache
        self.timeout = timeout
        self.get_retries = max(0, get_retries)
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        self._sleep = _sleep
        self._rng = _rng or random.Random()

    def request(
        self,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
    ) -> Tuple[int, Dict[str, Any]]:
        """Returns (status_code, parsed_json_or_{}). Raises HttpStatusError on
        4xx (other than the single retried 401) and TransientFabricError on
        transport failure / 5xx."""
        retries = self.get_retries if method.upper() == "GET" else 0
        delay = self.retry_base
        attempt = 0
        while True:
            try:
                return self._request_auth(method, path, body)
            except TransientFabricError:
                if attempt >= retries:
                    raise
                attempt += 1
                fabric_retries_total.inc(endpoint=self.base_url)
                # Decorrelated jitter: next ∈ U(base, 3·prev), capped.
                delay = min(
                    self.retry_cap, self._rng.uniform(self.retry_base, delay * 3)
                )
                self._sleep(delay)

    def _request_auth(
        self, method: str, path: str, body: Optional[Dict[str, Any]]
    ) -> Tuple[int, Dict[str, Any]]:
        try:
            return self._do(method, path, body)
        except HttpStatusError as e:
            if e.code == 401 and self.token_cache is not None:
                self.token_cache.invalidate()
                return self._do(method, path, body)
            raise

    def _do(
        self, method: str, path: str, body: Optional[Dict[str, Any]]
    ) -> Tuple[int, Dict[str, Any]]:
        url = self.base_url + path
        headers = {"Accept": "application/json"}
        # Causal propagation across the wire: when this call runs inside a
        # traced operation (the trace id is the durable pending_op nonce),
        # the fabric manager sees which control-plane op caused the request
        # — the header is the HTTP analog of the queue/dispatcher handoffs.
        ctx = tracing.context()
        if ctx is not None and ctx.trace_id:
            headers["X-Tpuc-Trace-Id"] = ctx.trace_id
        # Replica attribution: which replica issued this fabric verb. The
        # partition soak's fencing witness — the supervisor-side fabric
        # records (identity, monotonic time) per mutation and asserts a
        # fenced replica stopped mutating past its deadline.
        identity = os.environ.get("FABRIC_IDENTITY", "")
        if identity:
            headers["X-Tpuc-Replica"] = identity
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        if self.token_cache is not None:
            headers["Authorization"] = f"Bearer {self.token_cache.get()}"
        req = urllib.request.Request(url, data=data, headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, _parse(resp.read())
        except urllib.error.HTTPError as e:
            try:
                payload = _parse(e.read())
            except OSError:
                # Reading the error body failed (reset/timeout mid-read).
                # The status line already arrived — classify on it rather
                # than leak a raw socket error from inside this handler,
                # where the sibling except clauses can't catch it.
                payload = {}
            message = payload.get("error") or f"{method} {url}: HTTP {e.code}"
            raise http_status_error(e.code, message, payload) from e
        except (
            urllib.error.URLError,
            http.client.HTTPException,
            socket.timeout,
            OSError,
        ) as e:
            # URLError wraps refused/reset/DNS; socket.timeout covers a read
            # timing out mid-response; HTTPException covers malformed server
            # responses (BadStatusLine from a dying proxy/LB). All are
            # endpoint-reachability faults: typed transient, never a raw
            # urllib/http exception — and the breaker must count them as
            # failures, not read them as "the endpoint answered".
            raise TransientFabricError(f"{method} {url}: {e}") from e


def _parse(raw: bytes) -> Dict[str, Any]:
    if not raw:
        return {}
    try:
        parsed = json.loads(raw)
    except ValueError:
        return {}
    return parsed if isinstance(parsed, dict) else {"items": parsed}
