"""Cloud provider: login, token lifecycle, Space CRUD.

Reference: pkg/devspace/cloud — ``login.go:14-66`` (browser login with a
localhost callback server + EnsureLoggedIn), ``util.go:94`` (JWT claim
parse), ``create.go:8`` / ``get.go:147-404`` / ``delete.go:12`` (Space
CRUD over GraphQL), ``registry.go:27`` (registry credential fetch).

The GraphQL operation names mirror the reference's ``manager_*`` API
shape; the fake server in tests implements the same contract, which is
also the contract a self-hosted control plane must speak.

The port's copy of ``devspace_tpu/cloud/provider.py``, with the same
behaviour; its "not logged in" hint names the port's launcher.
"""

from __future__ import annotations

import base64
import binascii
import http.server
import json
import threading
import time
import urllib.parse
import webbrowser
from dataclasses import dataclass
from typing import Optional

from ..utils import log as logutil
from .config import CloudProvider, ProviderRegistry
from .graphql import GraphQLError, graphql_request

# Re-login this long before the JWT actually expires (reference re-news
# when less than a few minutes remain).
TOKEN_EXPIRY_SLACK = 300.0
LOGIN_TIMEOUT = 120.0


class CloudError(Exception):
    pass


@dataclass
class Space:
    space_id: int
    name: str
    namespace: str
    created: Optional[str] = None
    domain: Optional[str] = None


@dataclass
class ServiceAccount:
    namespace: str
    server: str
    ca_cert: str  # base64 PEM
    token: str


def parse_token_claims(token: str) -> dict:
    """Decode the claims segment of a JWT without verifying the signature
    (reference: cloud/util.go:94 — the CLI only reads exp/account id)."""
    parts = token.split(".")
    if len(parts) != 3:
        raise CloudError("malformed JWT: expected three dot-separated segments")
    payload = parts[1] + "=" * (-len(parts[1]) % 4)
    try:
        return json.loads(base64.urlsafe_b64decode(payload))
    except (ValueError, binascii.Error) as e:
        raise CloudError(f"malformed JWT claims: {e}") from e


def token_valid(token: Optional[str], slack: float = TOKEN_EXPIRY_SLACK) -> bool:
    if not token:
        return False
    try:
        claims = parse_token_claims(token)
    except CloudError:
        return False
    exp = claims.get("exp")
    if exp is None:
        return True
    return time.time() + slack < float(exp)


class Provider:
    """One configured cloud provider, bound to its registry entry."""

    def __init__(
        self,
        entry: CloudProvider,
        registry: Optional[ProviderRegistry] = None,
        logger: Optional[logutil.Logger] = None,
        insecure: bool = False,
    ):
        self.entry = entry
        self.registry = registry
        self.log = logger or logutil.get_logger()
        self.insecure = insecure

    # -- GraphQL ----------------------------------------------------------
    def graphql(self, query: str, variables: Optional[dict] = None, auth: bool = True):
        token = self.token() if auth else None
        try:
            return graphql_request(
                self.entry.host, query, variables, token=token, insecure=self.insecure
            )
        except GraphQLError as e:
            raise CloudError(str(e)) from e

    # -- auth -------------------------------------------------------------
    def token(self) -> str:
        """Return a valid short-lived JWT, minting one from the access key
        when the cached token is missing/expired (reference: token.go)."""
        if token_valid(self.entry.token):
            return self.entry.token
        if not self.entry.key:
            raise CloudError(
                f"not logged in to provider '{self.entry.name}' — "
                "run 'devspace-tpu-torch login' first"
            )
        try:
            data = graphql_request(
                self.entry.host,
                "mutation ($key: String!) { manager_getToken(key: $key) }",
                {"key": self.entry.key},
                insecure=self.insecure,
            )
        except GraphQLError as e:
            raise CloudError(str(e)) from e
        token = (data or {}).get("manager_getToken")
        if not token:
            raise CloudError("cloud API did not return a token for the access key")
        self.entry.token = token
        self._persist()
        return token

    def ensure_logged_in(self) -> None:
        """Reference: login.go:66 EnsureLoggedIn — interactive login when no
        key is stored, no-op otherwise."""
        if not self.entry.key:
            self.login()

    def login(self, key: Optional[str] = None, open_browser: bool = True) -> None:
        """Store an access key, obtaining it via the browser callback flow
        when not passed directly (reference: login.go:14-45 ReLogin)."""
        if key is None:
            key = self._browser_login(open_browser)
        self.entry.key = key
        self.entry.token = None
        # Validate immediately so a bad key fails at login, not first use.
        self.token()
        self._persist()
        self.log.done("[cloud] logged in to %s", self.entry.name)

    def _browser_login(self, open_browser: bool) -> str:
        """Spin up a localhost callback server, point the browser at
        ``<host>/login?cli=true&port=N`` and wait for the key redirect."""
        result: dict[str, str] = {}
        got_key = threading.Event()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self2):  # noqa: N805
                qs = urllib.parse.parse_qs(urllib.parse.urlparse(self2.path).query)
                if "key" in qs:
                    result["key"] = qs["key"][0]
                    got_key.set()
                    self2.send_response(200)
                    self2.end_headers()
                    self2.wfile.write(b"Login complete. You may close this tab.")
                else:
                    self2.send_response(400)
                    self2.end_headers()

            def log_message(self2, *a):  # noqa: N805
                pass

        server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"{self.entry.host}/login?cli=true&port={port}"
        self.log.info("[cloud] open %s to log in", url)
        if open_browser:
            try:
                webbrowser.open(url)
            except Exception:  # noqa: BLE001 — headless is fine, URL printed
                pass
        try:
            if not got_key.wait(LOGIN_TIMEOUT):
                raise CloudError("login timed out waiting for the browser callback")
        finally:
            server.shutdown()
            server.server_close()
        return result["key"]

    def _persist(self) -> None:
        if self.registry is not None:
            self.registry.save()

    # -- spaces -----------------------------------------------------------
    def create_space(self, name: str) -> Space:
        data = self.graphql(
            "mutation ($name: String!) {"
            " manager_createSpace(name: $name) { id name namespace created domain } }",
            {"name": name},
        )
        return _space_from(data["manager_createSpace"])

    def get_spaces(self) -> list[Space]:
        data = self.graphql(
            "query { manager_spaces { id name namespace created domain } }"
        )
        return [_space_from(s) for s in data.get("manager_spaces") or []]

    def get_space(self, name: str) -> Space:
        for space in self.get_spaces():
            if space.name == name or str(space.space_id) == name:
                return space
        raise CloudError(f"space '{name}' not found on provider '{self.entry.name}'")

    def delete_space(self, space_id: int) -> None:
        self.graphql(
            "mutation ($id: Int!) { manager_deleteSpace(spaceId: $id) }",
            {"id": space_id},
        )

    def get_service_account(self, space_id: int) -> ServiceAccount:
        """Per-space kube credentials (reference: get.go GetServiceAccount —
        server/caCert/token used to materialize the kube context)."""
        data = self.graphql(
            "query ($id: Int!) { manager_serviceAccount(spaceId: $id)"
            " { namespace server caCert token } }",
            {"id": space_id},
        )
        sa = data.get("manager_serviceAccount")
        if not sa:
            raise CloudError(f"no service account for space {space_id}")
        return ServiceAccount(
            namespace=sa["namespace"],
            server=sa["server"],
            ca_cert=sa.get("caCert", ""),
            token=sa["token"],
        )

    def get_registry_auth(self) -> Optional[dict]:
        """Container-registry credentials for the provider's registry
        (reference: registry.go:27 — used for auto docker login)."""
        data = self.graphql(
            "query { manager_registryAuth { registry username password } }"
        )
        return data.get("manager_registryAuth")


def _space_from(raw: dict) -> Space:
    return Space(
        space_id=int(raw["id"]),
        name=raw["name"],
        namespace=raw.get("namespace") or raw["name"],
        created=raw.get("created"),
        domain=raw.get("domain"),
    )
