"""Google Cloud Storage backend over the JSON API (copy of
greptimedb_tpu/objectstore/gcs.py; reference datanode/src/store.rs
through OpenDAL `services-gcs`): bearer-token auth, media upload and
download, paged listing. The endpoint is injectable for emulators and
the in-process test fake. A range read is one ranged media GET."""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from greptimedb_tpu_torch.objectstore import (
    OBJECT_STORE_BYTES,
    OBJECT_STORE_READS,
    ObjectStore,
    ObjectStoreError,
    _range_answer,
    _joined,
)
from greptimedb_tpu_torch.objectstore.s3 import http_error


class GcsStore(ObjectStore):
    name = "gcs"

    def __init__(self, bucket: str, prefix: str = "", *,
                 endpoint: Optional[str] = None,
                 token: Optional[str] = None):
        if not bucket:
            raise ObjectStoreError("gcs store requires a bucket")
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.endpoint = (endpoint or os.environ.get("GCS_ENDPOINT")
                         or "https://storage.googleapis.com").rstrip("/")
        self.token = token or os.environ.get("GCS_TOKEN", "")

    def _key(self, key: str) -> str:
        key = key.lstrip("/")
        return f"{self.prefix}/{key}" if self.prefix else key

    def _object_url(self, key: str, media: bool) -> str:
        enc = urllib.parse.quote(self._key(key), safe="")
        url = f"{self.endpoint}/storage/v1/b/{self.bucket}/o/{enc}"
        return url + "?alt=media" if media else url

    def _request(self, method: str, url: str,
                 data: Optional[bytes] = None,
                 headers: Optional[dict] = None) -> bytes:
        h = dict(headers or {})
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=h)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.read()
        except (urllib.error.HTTPError, urllib.error.URLError) as e:
            raise http_error("gcs", method, url, e) from None

    def _not_found(self, e: ObjectStoreError, key: str):
        if getattr(e, "http_code", None) == 404:
            return ObjectStoreError(f"not found: {key}")
        return e

    def _do_read(self, key: str) -> bytes:
        OBJECT_STORE_READS.inc(backend=self.name, outcome="read")
        try:
            data = self._request("GET", self._object_url(key, media=True))
        except ObjectStoreError as e:
            raise self._not_found(e, key) from None
        OBJECT_STORE_BYTES.inc(len(data))
        return data

    def _do_read_into(self, key: str, offset: int, buf) -> None:
        n = memoryview(buf).nbytes
        OBJECT_STORE_READS.inc(backend=self.name, outcome="range")
        try:
            data = self._request(
                "GET", self._object_url(key, media=True),
                headers={"Range": f"bytes={offset}-{offset + n - 1}"})
        except ObjectStoreError as e:
            raise self._not_found(e, key) from None
        OBJECT_STORE_BYTES.inc(len(data))
        _range_answer(key, data, offset, buf)

    def _do_write(self, key: str, data) -> None:
        name = urllib.parse.quote(self._key(key), safe="")
        url = (f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o"
               f"?uploadType=media&name={name}")
        self._request("POST", url, data=_joined(data),
                      headers={"Content-Type": "application/octet-stream"})

    def delete(self, key: str) -> None:
        try:
            self._request("DELETE", self._object_url(key, media=False))
        except ObjectStoreError as e:
            if getattr(e, "http_code", None) != 404:
                raise

    def exists(self, key: str) -> bool:
        try:
            self._request("GET", self._object_url(key, media=False))
            return True
        except ObjectStoreError as e:
            if getattr(e, "http_code", None) == 404:
                return False
            raise

    def size(self, key: str) -> int:
        try:
            meta = json.loads(
                self._request("GET", self._object_url(key, media=False)))
        except ObjectStoreError as e:
            raise self._not_found(e, key) from None
        return int(meta.get("size", 0))

    def list(self, prefix: str) -> list[str]:
        full = self._key(prefix)
        plen = len(self.prefix) + 1 if self.prefix else 0
        out: list[str] = []
        page_token = None
        while True:
            q = {"prefix": full}
            if page_token:
                q["pageToken"] = page_token
            url = (f"{self.endpoint}/storage/v1/b/{self.bucket}/o?"
                   + urllib.parse.urlencode(q))
            body = json.loads(self._request("GET", url))
            for item in body.get("items", []):
                out.append(item["name"][plen:])
            page_token = body.get("nextPageToken")
            if not page_token:
                return out
