"""One tiny stdlib HTTP-JSON client shared by the router, the WAL
shipper and the snapshot bootstrap (the port of ``knn_tpu/fleet/wire.py``;
no new deps — the serve stack's own rule).

Transport failures propagate as ``OSError`` (``urllib.error.URLError``
subclasses it), which is exactly what the resilience classifier treats
as transient at the ``fleet.*`` call sites; HTTP error statuses return
normally as ``(status, body)`` so callers can apply the routing rules
(retry a read elsewhere, never blindly re-send a write).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional


def request_json(method: str, url: str, payload: Optional[dict] = None,
                 timeout: float = 10.0,
                 headers: Optional[dict] = None) -> "tuple[int, dict]":
    """``(status, parsed-json-body)``; a non-JSON body comes back as
    ``{"raw": <first 400 chars>}`` so a misbehaving replica still yields
    a typed, loggable outcome rather than a parse traceback."""
    data = None
    hdrs = dict(headers or {})
    if payload is not None:
        data = json.dumps(payload).encode()
        hdrs.setdefault("Content-Type", "application/json")
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, _parse(r.read())
    except urllib.error.HTTPError as e:
        return e.code, _parse(e.read())


def forward_bytes(method: str, url: str, body: Optional[bytes],
                  timeout: float,
                  headers: Optional[dict] = None) -> "tuple[int, bytes]":
    """Raw pass-through for the router's proxy path: the replica's JSON
    body is already exactly what the client should see — re-encoding it
    would only cost time and risk reordering."""
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _parse(raw: bytes) -> dict:
    try:
        doc = json.loads(raw)
        if isinstance(doc, dict):
            return doc
        return {"raw": str(doc)[:400]}
    except ValueError:
        return {"raw": raw[:400].decode("utf-8", "replace")}
