"""The port's OAuth2 token cache (tpu_composer_torch/fabric/token.py)
against the JAX package's (tests/test_fabric_token.py's twin).

Each scenario runs once per package against one fake fabric server
(``tests/fake_fabric.FakeFabricServer``, reset between the two runs: the
token endpoint speaks JSON, so both packages' caches talk to the same
server) and records the
tokens' equality pattern, the server's token fetch count and the error
classes; the two records must be equal. Tolerance: exact. Timing is never
compared: JWT expiries are read back from tokens whose ``exp`` is fixed.
"""

from __future__ import annotations

import base64
import json
import threading

import pytest
import torch

from tests.fake_fabric import FakeFabricServer
from tests.torch_operator import run_both, run_both_served
from tpu_composer.fabric.inmem import InMemoryPool

torch.set_num_threads(1)


def _jwt(payload) -> str:
    def b64(obj):
        raw = json.dumps(obj).encode()
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    return f"{b64({'alg': 'none'})}.{b64(payload)}.sig"


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the class is compared
        return ("raised", type(e).__name__)


def decode(tw):
    d = tw.token.decode_jwt_expiry
    return [d(_jwt({"exp": 1893456000})), d(_jwt({"exp": "12"})),
            d(_jwt({"iss": "x"})), d("not-a-jwt"), d("a.b.c"), d(""),
            tw.token.EXPIRY_LEEWAY_S]


@pytest.fixture()
def server():
    srv = FakeFabricServer()
    yield srv
    srv.close()


def _served(scenario, srv, *args):
    return run_both_served(scenario, srv, InMemoryPool, *args,
                           knobs={"require_auth": True})


def fetch_and_cache(tw, srv):
    cache = tw.token.TokenCache(srv.token_url, "composer", "secret")
    t1, t2 = cache.get(), cache.get()
    return [t1 == t2, srv.token_requests]


def refresh_inside_leeway(tw, srv):
    srv.token_ttl = tw.token.EXPIRY_LEEWAY_S / 2
    cache = tw.token.TokenCache(srv.token_url, "composer", "secret")
    cache.get()
    cache.get()
    return [srv.token_requests]


def bad_credentials(tw, srv):
    cache = tw.token.TokenCache(srv.token_url, "composer", "wrong")
    return [_outcome(cache.get), srv.token_requests]


def invalidate_forces_refetch(tw, srv):
    cache = tw.token.TokenCache(srv.token_url, "composer", "secret")
    t1 = cache.get()
    cache.invalidate()
    t2 = cache.get()
    return [srv.token_requests, bool(t1) and bool(t2)]


def concurrent_gets_single_fetch(tw, srv):
    cache = tw.token.TokenCache(srv.token_url, "composer", "secret")
    barrier = threading.Barrier(8)
    tokens = []

    def worker():
        barrier.wait()
        tokens.append(cache.get())

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [len(tokens), len(set(tokens)), srv.token_requests]


def blip_tolerance_serves_valid_token(tw, srv):
    srv.token_ttl = tw.token.EXPIRY_LEEWAY_S + 2
    cache = tw.token.TokenCache(srv.token_url, "composer", "secret")
    tok = cache.get()
    srv.password = "rotated"
    return [cache.get() == tok, srv.token_requests]


def bearer_rides_every_request(tw, srv):
    cache = tw.token.TokenCache(srv.token_url, "composer", "secret")
    http = tw.httpx.JsonHttpClient(srv.url + "/v1", token_cache=cache)
    out = [http.request("GET", "/attachments")]
    srv.revoke_tokens()  # 401 -> invalidate, refetch, retry once
    out.append(http.request("GET", "/attachments"))
    out.append(srv.token_requests)
    bare = tw.httpx.JsonHttpClient(srv.url + "/v1", token_cache=None)
    out.append(_outcome(lambda: bare.request("GET", "/attachments")))
    return out


SERVER_SCENARIOS = {
    f.__name__: f for f in (
        fetch_and_cache, refresh_inside_leeway, bad_credentials,
        invalidate_forces_refetch, concurrent_gets_single_fetch,
        blip_tolerance_serves_valid_token, bearer_rides_every_request)
}


def test_decode_jwt_expiry_matches_jax():
    jax, port = run_both(decode)
    assert jax == port
    assert jax[0] == 1893456000.0 and jax[3:6] == [None, None, None]


@pytest.mark.parametrize("name", sorted(SERVER_SCENARIOS))
def test_token_cache_matches_jax(name, server):
    jax, port = _served(SERVER_SCENARIOS[name], server)
    assert jax == port


def _from_env(tw, srv, tmp_path, monkeypatch):
    creds = tmp_path / "credentials.json"
    creds.write_text(json.dumps({"username": "composer", "password": "secret"}))
    monkeypatch.setenv("FABRIC_AUTH_URL", srv.token_url)
    monkeypatch.setenv("FABRIC_CREDENTIALS_FILE", str(creds))
    cache = tw.token.TokenCache.from_env()
    out = [cache is not None, bool(cache.get()), srv.token_requests]
    monkeypatch.delenv("FABRIC_AUTH_URL")
    out.append(tw.token.TokenCache.from_env())
    monkeypatch.setenv("FABRIC_AUTH_URL", "http://127.0.0.1:9/token")
    monkeypatch.delenv("FABRIC_CREDENTIALS_FILE")
    for k in ("FABRIC_USERNAME", "FABRIC_PASSWORD"):
        monkeypatch.delenv(k, raising=False)
    out.append(_outcome(tw.token.TokenCache.from_env))
    return out


def test_from_env_matches_jax(server, tmp_path, monkeypatch):
    jax, port = _served(_from_env, server, tmp_path, monkeypatch)
    assert jax == port
    assert jax[-1] == ["raised", "AuthError"]
