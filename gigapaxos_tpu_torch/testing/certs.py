"""Throwaway deployment CA for TLS tests.

Deployments bring real certificates (the reference ships keystore files,
``javax.net.ssl.*`` properties); tests need a self-contained CA that signs
per-endpoint certificates so SERVER_AUTH and MUTUAL_AUTH paths run for
real — handshakes, verification, and rejection of unauthenticated peers.
"""

from __future__ import annotations

import datetime
import os
from typing import Tuple

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import rsa
from cryptography.x509.oid import NameOID


def _key():
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _name(cn: str):
    return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])


def _write_key(path: str, key) -> None:
    with open(path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        ))


def _write_cert(path: str, cert) -> None:
    with open(path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))


def make_test_ca(dir_path: str, endpoints: Tuple[str, ...] = ("node", "client")):
    """Create ``ca.pem`` plus ``<ep>.pem``/``<ep>.key`` for each endpoint.

    Returns {"ca": capath, "<ep>": (certpath, keypath), ...}.
    """
    os.makedirs(dir_path, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    ca_key = _key()
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(_name("gptpu-test-ca"))
        .issuer_name(_name("gptpu-test-ca"))
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .sign(ca_key, hashes.SHA256())
    )
    ca_path = os.path.join(dir_path, "ca.pem")
    _write_cert(ca_path, ca_cert)
    out = {"ca": ca_path}
    for ep in endpoints:
        key = _key()
        cert = (
            x509.CertificateBuilder()
            .subject_name(_name(ep))
            .issuer_name(ca_cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(
                x509.SubjectAlternativeName([x509.DNSName("localhost")]),
                critical=False,
            )
            .sign(ca_key, hashes.SHA256())
        )
        cpath = os.path.join(dir_path, f"{ep}.pem")
        kpath = os.path.join(dir_path, f"{ep}.key")
        _write_cert(cpath, cert)
        _write_key(kpath, key)
        out[ep] = (cpath, kpath)
    return out
