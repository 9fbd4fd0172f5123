"""Minimal GraphQL-over-HTTP client (stdlib only).

Reference: pkg/devspace/cloud/graphql.go:10-26 — POST ``{query,variables}``
to ``<host>/graphql`` with an Authorization bearer header; surface GraphQL
``errors`` as exceptions.

The port's copy of ``devspace_tpu/cloud/graphql.py``, with the same behaviour.
"""

from __future__ import annotations

import json
import ssl
import urllib.error
import urllib.request
from typing import Any, Optional


class GraphQLError(Exception):
    pass


def graphql_request(
    host: str,
    query: str,
    variables: Optional[dict] = None,
    token: Optional[str] = None,
    timeout: float = 30.0,
    insecure: bool = False,
) -> Any:
    """Run one GraphQL request and return the ``data`` payload."""
    body = json.dumps({"query": query, "variables": variables or {}}).encode()
    req = urllib.request.Request(
        host.rstrip("/") + "/graphql",
        data=body,
        headers={
            "Content-Type": "application/json",
            **({"Authorization": f"Bearer {token}"} if token else {}),
        },
        method="POST",
    )
    ctx = None
    if insecure:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    try:
        with urllib.request.urlopen(req, timeout=timeout, context=ctx) as resp:
            payload = json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        detail = ""
        try:
            detail = e.read().decode()[:500]
        except Exception:  # noqa: BLE001
            pass
        raise GraphQLError(f"cloud API returned HTTP {e.code}: {detail}") from e
    except urllib.error.URLError as e:
        raise GraphQLError(f"cloud API unreachable at {host}: {e.reason}") from e
    if payload.get("errors"):
        msgs = "; ".join(
            e.get("message", str(e)) for e in payload["errors"]
        )
        raise GraphQLError(f"cloud API error: {msgs}")
    return payload.get("data")
