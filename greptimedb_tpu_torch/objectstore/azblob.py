"""Azure Blob Storage backend with SharedKey request signing (copy of
greptimedb_tpu/objectstore/azblob.py; reference datanode/src/store.rs
through OpenDAL `services-azblob`): the SharedKey scheme signs VERB +
canonicalized headers + canonicalized resource with HMAC-SHA256 over the
base64 account key. The endpoint is injectable for Azurite-style
emulators and the in-process test fake. A range read is one GET with a
signed `Range` header."""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Optional

from greptimedb_tpu_torch.objectstore import (
    OBJECT_STORE_BYTES,
    OBJECT_STORE_READS,
    ObjectStore,
    ObjectStoreError,
    _range_answer,
    _joined,
)
from greptimedb_tpu_torch.objectstore.s3 import delete_call, http_error

API_VERSION = "2021-08-06"


def sign_shared_key(method: str, url: str, headers: dict, account: str,
                    key_b64: str) -> str:
    """Authorization header value for a SharedKey request. `headers` must
    already include x-ms-date and x-ms-version."""
    parts = urllib.parse.urlsplit(url)
    # canonicalized x-ms-* headers, lower-cased, sorted
    ms = sorted((k.lower(), v.strip()) for k, v in headers.items()
                if k.lower().startswith("x-ms-"))
    canon_headers = "".join(f"{k}:{v}\n" for k, v in ms)
    # canonicalized resource: /account/path + sorted query params
    canon_res = f"/{account}{parts.path}"
    if parts.query:
        q = urllib.parse.parse_qs(parts.query, keep_blank_values=True)
        for k in sorted(q):
            canon_res += f"\n{k.lower()}:{','.join(sorted(q[k]))}"
    length = headers.get("Content-Length", "")
    if length == "0":
        length = ""  # 2015-02-21+ semantics: empty when zero
    to_sign = "\n".join([
        method.upper(),
        headers.get("Content-Encoding", ""),
        headers.get("Content-Language", ""),
        length,
        headers.get("Content-MD5", ""),
        headers.get("Content-Type", ""),
        "",  # Date (empty: x-ms-date is set)
        headers.get("If-Modified-Since", ""),
        headers.get("If-Match", ""),
        headers.get("If-None-Match", ""),
        headers.get("If-Unmodified-Since", ""),
        headers.get("Range", ""),
    ]) + "\n" + canon_headers + canon_res
    mac = hmac.new(base64.b64decode(key_b64), to_sign.encode("utf-8"),
                   hashlib.sha256)
    return f"SharedKey {account}:{base64.b64encode(mac.digest()).decode()}"


class AzblobStore(ObjectStore):
    name = "azblob"

    def __init__(self, container: str, prefix: str = "", *,
                 account_name: Optional[str] = None,
                 account_key: Optional[str] = None,
                 endpoint: Optional[str] = None):
        if not container:
            raise ObjectStoreError("azblob store requires a container")
        self.container = container
        self.prefix = prefix.strip("/")
        self.account = account_name or os.environ.get(
            "AZURE_STORAGE_ACCOUNT", "")
        self.key = account_key or os.environ.get("AZURE_STORAGE_KEY", "")
        if not self.account or not self.key:
            raise ObjectStoreError(
                "azblob store requires account_name and account_key")
        self.endpoint = (endpoint or os.environ.get("AZBLOB_ENDPOINT")
                         or f"https://{self.account}.blob.core.windows.net"
                         ).rstrip("/")

    def _key(self, key: str) -> str:
        key = key.lstrip("/")
        return f"{self.prefix}/{key}" if self.prefix else key

    def _url(self, key: str) -> str:
        enc = urllib.parse.quote(self._key(key))
        return f"{self.endpoint}/{self.container}/{enc}"

    def _request(self, method: str, url: str,
                 data: Optional[bytes] = None,
                 extra_headers: Optional[dict] = None
                 ) -> tuple[bytes, dict]:
        """(body, response headers): headers are returned, never kept on
        the instance (the store is shared across threads)."""
        now = datetime.datetime.now(datetime.timezone.utc)
        headers = {
            "x-ms-date": now.strftime("%a, %d %b %Y %H:%M:%S GMT"),
            "x-ms-version": API_VERSION,
            "Content-Length": str(len(data) if data is not None else 0),
            **(extra_headers or {}),
        }
        headers["Authorization"] = sign_shared_key(
            method, url, headers, self.account, self.key)
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.read(), dict(resp.headers)
        except (urllib.error.HTTPError, urllib.error.URLError) as e:
            raise http_error("azblob", method, url, e) from None

    def _get(self, key: str, extra: Optional[dict] = None) -> bytes:
        try:
            return self._request("GET", self._url(key),
                                 extra_headers=extra)[0]
        except ObjectStoreError as e:
            if getattr(e, "http_code", None) == 404:
                raise ObjectStoreError(f"not found: {key}") from None
            raise

    def _do_read(self, key: str) -> bytes:
        OBJECT_STORE_READS.inc(backend=self.name, outcome="read")
        data = self._get(key)
        OBJECT_STORE_BYTES.inc(len(data))
        return data

    def _do_read_into(self, key: str, offset: int, buf) -> None:
        n = memoryview(buf).nbytes
        OBJECT_STORE_READS.inc(backend=self.name, outcome="range")
        data = self._get(key, {"Range": f"bytes={offset}-{offset + n - 1}"})
        OBJECT_STORE_BYTES.inc(len(data))
        _range_answer(key, data, offset, buf)

    def _do_write(self, key: str, data) -> None:
        self._request("PUT", self._url(key), data=_joined(data),
                      extra_headers={"x-ms-blob-type": "BlockBlob",
                                     "Content-Type":
                                         "application/octet-stream"})

    def delete(self, key: str) -> None:
        delete_call(lambda: self._request("DELETE", self._url(key)))

    def exists(self, key: str) -> bool:
        try:
            self._request("HEAD", self._url(key))
            return True
        except ObjectStoreError as e:
            if getattr(e, "http_code", None) == 404:
                return False
            raise

    def size(self, key: str) -> int:
        try:
            _, headers = self._request("HEAD", self._url(key))
        except ObjectStoreError as e:
            if getattr(e, "http_code", None) == 404:
                raise ObjectStoreError(f"not found: {key}") from None
            raise
        return int(headers.get("Content-Length", 0))

    def list(self, prefix: str) -> list[str]:
        full = self._key(prefix)
        plen = len(self.prefix) + 1 if self.prefix else 0
        out: list[str] = []
        marker = ""
        while True:
            q = {"restype": "container", "comp": "list", "prefix": full}
            if marker:
                q["marker"] = marker
            url = (f"{self.endpoint}/{self.container}?"
                   + urllib.parse.urlencode(q))
            root = ET.fromstring(self._request("GET", url)[0].decode())
            for blob in root.iter("Blob"):
                out.append(blob.findtext("Name")[plen:])
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return out
