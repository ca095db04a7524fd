"""OAuth2 password-grant token cache for fabric/pool-manager auth.

Port of ``tpu_composer/fabric/token.py``: the same wire format, defaults,
error classes and metric names.

Reference analog: internal/cdi/fti/token.go — a double-checked-locked cached
bearer token (token.go:74-101) obtained by password grant against a
Keycloak-style id_manager (token.go:103-132), with expiry parsed out of the
JWT payload (token.go:158-172) and a 30s renewal leeway (token.go:69).

Deltas from the reference:
- credentials come from env vars or a JSON credentials file instead of a
  Kubernetes Secret named ``credentials`` (token.go:104-116) — the standalone
  control plane has no Secret store; the deploy manifests mount the Secret as
  a file and point ``FABRIC_CREDENTIALS_FILE`` at it, which is the same
  trust path one hop earlier;
- a failed refresh keeps serving the old token until it actually expires,
  so a blip in the auth service does not fail in-flight reconciles.
"""

from __future__ import annotations

import base64
import binascii
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from tpu_composer_torch.fabric.provider import FabricError

# Renew this many seconds before the token actually expires (token.go:69).
EXPIRY_LEEWAY_S = 30.0
# Timeout for the token endpoint itself (token.go:40).
TOKEN_TIMEOUT_S = 30.0


class AuthError(FabricError):
    """Token endpoint rejected us or returned garbage."""


def decode_jwt_expiry(token: str) -> Optional[float]:
    """Unix expiry from an (unverified) JWT payload, or None.

    The reference does the same signature-free decode purely to learn the
    expiry (token.go:158-172); trust comes from TLS to the issuer, not from
    verifying our own token.
    """
    parts = token.split(".")
    if len(parts) != 3:
        return None
    payload = parts[1]
    payload += "=" * (-len(payload) % 4)
    try:
        claims = json.loads(base64.urlsafe_b64decode(payload))
    except (ValueError, binascii.Error):
        return None
    exp = claims.get("exp")
    if isinstance(exp, (int, float)) and exp > 0:
        return float(exp)
    return None


class TokenCache:
    """Thread-safe cached bearer token with refresh-before-expiry."""

    def __init__(
        self,
        token_url: str,
        username: str,
        password: str,
        client_id: str = "tpu-composer",
        client_secret: str = "",
        timeout: float = TOKEN_TIMEOUT_S,
    ) -> None:
        self.token_url = token_url
        self.username = username
        self.password = password
        self.client_id = client_id
        self.client_secret = client_secret
        self.timeout = timeout
        self._lock = threading.Lock()
        self._token: str = ""
        self._expiry: float = 0.0  # unix seconds; 0 == no token

    @classmethod
    def from_env(cls) -> Optional["TokenCache"]:
        """Build from FABRIC_AUTH_URL + credentials env/file, or None.

        Credentials resolution order:
        1. ``FABRIC_CREDENTIALS_FILE`` — JSON ``{"username", "password",
           ["client_id"], ["client_secret"]}`` (the mounted-Secret path);
        2. ``FABRIC_USERNAME`` / ``FABRIC_PASSWORD`` env vars.
        """
        url = os.environ.get("FABRIC_AUTH_URL", "")
        if not url:
            return None
        username = os.environ.get("FABRIC_USERNAME", "")
        password = os.environ.get("FABRIC_PASSWORD", "")
        client_id = os.environ.get("FABRIC_CLIENT_ID", "tpu-composer")
        client_secret = os.environ.get("FABRIC_CLIENT_SECRET", "")
        cred_file = os.environ.get("FABRIC_CREDENTIALS_FILE", "")
        if cred_file:
            with open(cred_file, "r", encoding="utf-8") as f:
                creds = json.load(f)
            username = creds.get("username", username)
            password = creds.get("password", password)
            client_id = creds.get("client_id", client_id)
            client_secret = creds.get("client_secret", client_secret)
        if not username:
            raise AuthError(
                "FABRIC_AUTH_URL set but no credentials: provide "
                "FABRIC_CREDENTIALS_FILE or FABRIC_USERNAME/FABRIC_PASSWORD"
            )
        return cls(url, username, password, client_id, client_secret)

    def get(self) -> str:
        """Current bearer token, refreshing if within the expiry leeway.

        Double-checked locking as in the reference (token.go:74-101): the
        fast path re-reads under the lock so only one thread refreshes.
        """
        now = time.time()
        if self._token and now < self._expiry - EXPIRY_LEEWAY_S:
            return self._token
        with self._lock:
            now = time.time()
            if self._token and now < self._expiry - EXPIRY_LEEWAY_S:
                return self._token
            try:
                token, expiry = self._fetch()
            except AuthError:
                # Keep serving a still-valid token through auth-service blips.
                if self._token and now < self._expiry:
                    return self._token
                raise
            self._token, self._expiry = token, expiry
            return self._token

    def invalidate(self) -> None:
        """Drop the cached token (called on a 401 from the fabric API)."""
        with self._lock:
            self._token = ""
            self._expiry = 0.0

    def _fetch(self) -> tuple:
        form = {
            "grant_type": "password",
            "client_id": self.client_id,
            "username": self.username,
            "password": self.password,
        }
        if self.client_secret:
            form["client_secret"] = self.client_secret
        req = urllib.request.Request(
            self.token_url,
            data=urllib.parse.urlencode(form).encode(),
            headers={"Content-Type": "application/x-www-form-urlencoded"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise AuthError(f"token endpoint {self.token_url}: HTTP {e.code}") from e
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise AuthError(f"token endpoint {self.token_url}: {e}") from e
        token = body.get("access_token", "")
        if not token:
            raise AuthError(f"token endpoint {self.token_url}: no access_token")
        # Prefer the JWT's own exp claim; fall back to expires_in.
        expiry = decode_jwt_expiry(token)
        if expiry is None:
            expires_in = body.get("expires_in")
            if isinstance(expires_in, (int, float)) and expires_in > 0:
                expiry = time.time() + float(expires_in)
            else:
                # Opaque token without expiry info: refresh every minute.
                expiry = time.time() + 60.0 + EXPIRY_LEEWAY_S
        return token, float(expiry)
