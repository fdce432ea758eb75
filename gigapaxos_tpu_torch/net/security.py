"""Transport security: CLEAR / SERVER_AUTH / MUTUAL_AUTH.

Analog of the reference's SSL stack (``nio/SSLDataProcessingWorker.java:59``
``SSL_MODES {CLEAR, SERVER_AUTH, MUTUAL_AUTH}``, selected per node role at
``reconfiguration/ReconfigurableNode.java:298``): the same three modes wrap
the framed TCP transport (``net/transport.py``) with stdlib ``ssl``.

* CLEAR        — plaintext (intra-datacenter ICI-adjacent links);
* SERVER_AUTH  — servers present certificates, clients verify against the
  deployment CA; client edge privacy without client certs;
* MUTUAL_AUTH  — additionally, clients must present certificates the CA
  signed (the reference requires this for admin/create operations and
  server-to-server links).

Certificates are deployment artifacts (the reference ships keystore files
configured via ``javax.net.ssl.*`` properties); tests generate a throwaway
CA.  Node ids are not hostnames, so
hostname checking is off — peer identity is the CA-signed certificate plus
the node-id hello, exactly the reference's keystore trust model.
"""

from __future__ import annotations

import enum
import ssl
from dataclasses import dataclass
from typing import Optional


class SSLMode(enum.Enum):
    CLEAR = "clear"
    SERVER_AUTH = "server_auth"
    MUTUAL_AUTH = "mutual_auth"


@dataclass
class TransportSecurity:
    """Everything one endpoint needs to speak TLS in a deployment.

    ``certfile``/``keyfile`` identify THIS endpoint (server role always;
    client role under MUTUAL_AUTH); ``cafile`` is the deployment trust
    root every certificate must chain to.
    """

    mode: SSLMode = SSLMode.CLEAR
    certfile: Optional[str] = None
    keyfile: Optional[str] = None
    cafile: Optional[str] = None

    @classmethod
    def from_config(cls, ssl_cfg) -> Optional["TransportSecurity"]:
        """Build from the config registry's ``ssl`` section (None = CLEAR,
        no wrapping at all)."""
        if ssl_cfg is None:
            return None
        mode = SSLMode(ssl_cfg.mode)
        if mode is SSLMode.CLEAR:
            return None
        return cls(
            mode=mode,
            certfile=ssl_cfg.certfile or None,
            keyfile=ssl_cfg.keyfile or None,
            cafile=ssl_cfg.cafile or None,
        )

    # ------------------------------------------------------------- contexts
    def server_context(self) -> Optional[ssl.SSLContext]:
        """Context for accepted connections (both modes present a cert;
        MUTUAL_AUTH additionally demands and verifies the client's).

        An endpoint with no certificate of its own is client-only: it can
        dial TLS peers but cannot accept TLS connections (peers dialing it
        back fail their handshake and drop) — the shape of a certless
        client under MUTUAL_AUTH, which can reach nobody anyway."""
        if self.mode is SSLMode.CLEAR or not self.certfile:
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certfile, self.keyfile)
        if self.mode is SSLMode.MUTUAL_AUTH:
            if not self.cafile:
                raise ValueError("mutual_auth requires cafile")
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(self.cafile)
        return ctx

    def client_context(self) -> Optional[ssl.SSLContext]:
        """Context for outbound connections: always verifies the server
        against the CA; presents our certificate when we have one (required
        by MUTUAL_AUTH servers)."""
        if self.mode is SSLMode.CLEAR:
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        if not self.cafile:
            raise ValueError(f"{self.mode.value} requires cafile")
        ctx.check_hostname = False  # node ids, not hostnames (see module doc)
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(self.cafile)
        if self.certfile:
            ctx.load_cert_chain(self.certfile, self.keyfile)
        return ctx
