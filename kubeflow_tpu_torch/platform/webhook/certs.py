"""Self-signed serving certificates for the admission webhook.  The
port's copy of ``kubeflow_tpu/platform/webhook/certs.py``, whole.

The reference serves admission HTTPS-only, with certwatcher-based rotation
of the mounted cert/key pair (reference admission-webhook/main.go:753-770,
config.go:43-60); in-cluster the pair comes from cert-manager.  This
module is the hermetic stand-in: generate a self-signed pair for tests,
the e2e gate and the demo topology — rotation then works exactly like
cert-manager renewal (new files on disk, live reload, no restart).

Key generation uses the ``cryptography`` package, imported inside
``generate_self_signed`` only: a machine without it imports this module
and writes pairs made elsewhere (the ``openssl`` command line makes the
same pair: ECDSA P-256, the same SANs, marked CA).  ECDSA P-256 so
keygen is fast enough to run inside every test.
"""
from __future__ import annotations

import datetime
import ipaddress
import os
from typing import Iterable, Tuple


def generate_self_signed(
    cn: str = "kft-webhook",
    hosts: Iterable[str] = ("127.0.0.1", "localhost"),
    days: int = 1,
) -> Tuple[bytes, bytes]:
    """Return (cert_pem, key_pem) for a self-signed serving cert.

    The cert is its own issuer and marked CA, so clients can pin it as
    ``cafile`` — a strict-verification handshake then succeeds only
    against a server presenting exactly this pair, which is what lets the
    rotation tests prove the server really reloaded.
    """
    # Imported here, not at module top: ``write_pair``'s atomic-rotation
    # machinery has no crypto dependency and must stay importable on
    # images without the ``cryptography`` package (keygen then comes from
    # cert-manager / out-of-band files).
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])
    sans = []
    for h in hosts:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            sans.append(x509.DNSName(h))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .add_extension(
            x509.BasicConstraints(ca=True, path_length=None), critical=True
        )
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    return cert_pem, key_pem


def write_pair(directory: str, cert_pem: bytes, key_pem: bytes
               ) -> Tuple[str, str]:
    """Write tls.crt/tls.key under ``directory`` (the cert-manager secret
    layout) atomically: BOTH temp files are fully written and fsynced to
    disk first, and only then renamed into place (key first, then cert,
    back to back).  Ordering matters twice over:

    * a writer killed mid-write (crash, OOM, SIGKILL) leaves at most a
      stale ``.tmp`` file — the live pair is never truncated, because the
      target paths are only ever touched by atomic rename;
    * the reloader can observe at most the tiny window between the two
      renames (new key + old cert); its trial-load rejects the mismatched
      pair and retries next tick without ever poisoning the live context
      (WebhookServer.reload_certs).
    """
    tmps = []
    for fname, blob in (("tls.key", key_pem), ("tls.crt", cert_pem)):
        path = os.path.join(directory, fname)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        tmps.append((tmp, path))
    paths = []
    for tmp, path in tmps:
        os.replace(tmp, path)
        paths.append(path)
    return paths[1], paths[0]  # (cert_path, key_path)
