"""TLS for internal communication (internal-communication.https).

Counterpart of presto_tpu/server/tls.py: the stdlib `ssl` module wraps
the socket of each server given `tls=(cert, key)` (worker, discovery,
statement server), and `trust(ca_file)` installs a process-wide https
opener carrying the cluster CA, so every urllib client verifies its
peers; the pooled WorkerClient reads the same context through
`client_ssl_context`. `generate_self_signed` mints a CA and server
certificate through the `cryptography` package, imported at its first
use: where it does not import, the call raises that ImportError. A
server that cannot start TLS raises; it never serves plain HTTP
instead.
"""

from __future__ import annotations

import datetime
import os
import ssl
import urllib.request
from typing import Optional, Tuple

__all__ = ["generate_self_signed", "server_context", "trust", "client_ssl_context",
           "clear_trust"]


def generate_self_signed(directory: str,
                         common_name: str = "presto-tpu-internal",
                         alt_names: Tuple[str, ...] = ("localhost",
                                                       "127.0.0.1")
                         ) -> Tuple[str, str]:
    """Mint a self-signed certificate + key under `directory`; returns
    (cert_path, key_path). The cert doubles as the cluster CA for
    trust() (single-cert internal PKI, the dev/test topology)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID
    import ipaddress

    os.makedirs(directory, exist_ok=True)
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    sans = []
    for n in alt_names:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(n)))
        except ValueError:
            sans.append(x509.DNSName(n))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.SubjectAlternativeName(sans),
                           critical=False)
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .sign(key, hashes.SHA256()))
    cert_path = os.path.join(directory, "internal.crt")
    key_path = os.path.join(directory, "internal.key")
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    return cert_path, key_path


def server_context(certfile: str, keyfile: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


_opener_installed = False


_client_context = None


def trust(ca_file: str) -> None:
    """Install a process-wide https opener that verifies peers against
    the cluster CA -- every internal urllib client picks it up (the
    pooled WorkerClient reads the same context via
    client_ssl_context)."""
    global _opener_installed, _client_context
    ctx = ssl.create_default_context(cafile=ca_file)
    # internal certs name the cluster, not each ephemeral host:port;
    # peer identity is the CA signature + the JWT layer
    ctx.check_hostname = False
    opener = urllib.request.build_opener(
        urllib.request.HTTPSHandler(context=ctx))
    urllib.request.install_opener(opener)
    _client_context = ctx
    _opener_installed = True


def client_ssl_context():
    """The trusted cluster context (None = stdlib default verify)."""
    return _client_context


def clear_trust() -> None:
    global _opener_installed, _client_context
    urllib.request.install_opener(
        urllib.request.build_opener())
    _client_context = None
    _opener_installed = False
