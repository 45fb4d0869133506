"""Internal authentication: HS256 JWT bearers from a shared secret.

Counterpart of presto_tpu/server/auth.py (presto-internal-
communication's InternalAuthenticationManager): with a cluster secret
configured, every coordinator, worker and discovery request carries an
HS256 JWT in the `X-Presto-Internal-Bearer` header (subject: the
sender's node id, about five minutes to expiry), and servers answer a
request whose token is missing, tampered with or expired with 401. The
signing key is the SHA-256 of the secret, as in the reference, and the
token bytes are the reference's for the same secret, payload and clock,
so either package's nodes authenticate to the other's. The secret
comes from the caller, else `set_shared_secret`, else the
PRESTO_TPU_INTERNAL_SECRET environment variable. The locks are
`OrderedLock`s under the reference's names (utils/locks.py).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import Optional

from ..utils.locks import OrderedLock


__all__ = ["AuthError", "InternalAuthenticator", "INTERNAL_BEARER_HEADER",
           "sign_jwt", "verify_jwt", "set_shared_secret",
           "get_shared_secret", "make_authenticator", "bearer_headers",
           "authorize_request"]

INTERNAL_BEARER_HEADER = "X-Presto-Internal-Bearer"

_shared_secret_lock = OrderedLock("auth._shared_secret_lock")
_shared_secret: Optional[str] = None


class AuthError(Exception):
    """Missing/invalid/expired internal bearer."""


def set_shared_secret(secret: Optional[str]) -> None:
    """Process-wide cluster secret (the config-file analog); None
    disables internal authentication."""
    global _shared_secret
    with _shared_secret_lock:
        _shared_secret = secret


def get_shared_secret() -> Optional[str]:
    with _shared_secret_lock:
        if _shared_secret is not None:
            return _shared_secret
    return os.environ.get("PRESTO_TPU_INTERNAL_SECRET") or None


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def _signing_key(secret: str) -> bytes:
    """SHA-256 of the shared secret, matching the reference
    InternalAuthenticationManager's key derivation — tokens minted here
    validate against a Presto coordinator/worker sharing the secret."""
    return hashlib.sha256(secret.encode()).digest()


def sign_jwt(secret: str, payload: dict) -> str:
    """Compact HS256 JWS over `payload`."""
    header = _b64url(b'{"alg":"HS256","typ":"JWT"}')
    body = _b64url(json.dumps(payload, separators=(",", ":"),
                              sort_keys=True).encode())
    signing_input = f"{header}.{body}".encode()
    sig = hmac.new(_signing_key(secret), signing_input,
                   hashlib.sha256).digest()
    return f"{header}.{body}.{_b64url(sig)}"


def verify_jwt(secret: str, token: str, leeway_s: float = 30.0) -> dict:
    """Signature + expiry check; returns the payload. Raises AuthError
    on any defect (never distinguishes why, like the reference)."""
    try:
        header_b64, body_b64, sig_b64 = token.split(".")
        signing_input = f"{header_b64}.{body_b64}".encode()
        expect = hmac.new(_signing_key(secret), signing_input,
                          hashlib.sha256).digest()
        if not hmac.compare_digest(expect, _b64url_decode(sig_b64)):
            raise AuthError("bad signature")
        header = json.loads(_b64url_decode(header_b64))
        if header.get("alg") != "HS256":  # no alg-confusion downgrades
            raise AuthError("bad alg")
        payload = json.loads(_b64url_decode(body_b64))
    except AuthError:
        raise
    except Exception as e:
        raise AuthError(f"malformed token: {type(e).__name__}") from None
    exp = payload.get("exp")
    if exp is not None and time.time() > float(exp) + leeway_s:
        raise AuthError("expired")
    return payload


class InternalAuthenticator:
    """Per-node token minter + request verifier. Tokens are cached and
    re-minted at ~80% of their lifetime (the reference re-signs per
    request; caching is equivalent under the expiry contract)."""

    def __init__(self, secret: str, node_id: str = "",
                 ttl_s: float = 300.0):
        assert secret, "internal authentication needs a non-empty secret"
        self.secret = secret
        self.node_id = node_id
        self.ttl_s = ttl_s
        self._lock = OrderedLock("auth.InternalAuthenticator._lock")
        self._token: Optional[str] = None
        self._token_exp = 0.0

    def bearer(self) -> str:
        now = time.time()
        with self._lock:
            if self._token is None or now > self._token_exp - 0.2 * self.ttl_s:
                exp = now + self.ttl_s
                self._token = sign_jwt(
                    self.secret, {"sub": self.node_id, "iat": int(now),
                                  "exp": int(exp)})
                self._token_exp = exp
            return self._token

    def verify(self, token: Optional[str]) -> dict:
        if not token:
            raise AuthError("missing internal bearer")
        return verify_jwt(self.secret, token)


def make_authenticator(shared_secret: Optional[str],
                       node_id: str) -> Optional[InternalAuthenticator]:
    """The one secret-resolution idiom: an explicit secret wins, else the
    process/env-wide one; None (no secret anywhere) = open cluster."""
    secret = shared_secret if shared_secret is not None \
        else get_shared_secret()
    return InternalAuthenticator(secret, node_id) if secret else None


_default_auth: Optional[InternalAuthenticator] = None


def bearer_headers(auth: Optional[InternalAuthenticator] = None
                   ) -> dict:
    """Outbound internal-bearer header (cached tokens). With no
    authenticator given, a process-wide one is kept for the configured
    shared secret (re-created if the secret changes)."""
    global _default_auth
    if auth is None:
        secret = get_shared_secret()
        if not secret:
            _default_auth = None
            return {}
        if _default_auth is None or _default_auth.secret != secret:
            _default_auth = InternalAuthenticator(secret, "internal")
        auth = _default_auth
    return {INTERNAL_BEARER_HEADER: auth.bearer()}


def authorize_request(handler, authenticator,
                      send_json) -> bool:
    """InternalAuthenticationFilter analog for BaseHTTPRequestHandler
    subclasses: verify the bearer; on failure, DRAIN any request body
    (keep-alive framing: unread bytes would be parsed as the next
    request line) and send a 401."""
    if authenticator is None:
        return True
    try:
        authenticator.verify(
            handler.headers.get(INTERNAL_BEARER_HEADER))
        return True
    except AuthError as e:
        length = int(handler.headers.get("Content-Length", "0") or 0)
        while length > 0:
            chunk = handler.rfile.read(min(length, 1 << 16))
            if not chunk:
                break
            length -= len(chunk)
        send_json({"error": f"unauthorized: {e}"}, 401)
        return False
