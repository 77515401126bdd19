"""S3-compatible object-store backend, AWS SigV4 over plain HTTP(S)
(copy of greptimedb_tpu/objectstore/s3.py; reference
src/datanode/src/store/s3.rs). One REST backend covers AWS S3, MinIO,
Ceph RGW and the S3-compatible modes of OSS and GCS: the endpoint and
the credentials select the vendor (`from_url`). Standard library only
(urllib and hmac); the payload hash rides x-amz-content-sha256.

Beyond the JAX store: `_do_read_into` is one ranged GET (`Range:
bytes=a-b`, sent unsigned: SigV4 needs only host and the x-amz-*
headers signed), and `name` is "s3" (the JAX class keeps the base
name).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import html
import os
import re
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


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_v4(method: str, url: str, headers: dict, payload_hash: str,
            access_key: str, secret_key: str, region: str,
            service: str = "s3",
            now: Optional[datetime.datetime] = None) -> dict:
    """Return the headers to add (Authorization, x-amz-date,
    x-amz-content-sha256) for an AWS SigV4-signed request."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    parsed = urllib.parse.urlsplit(url)
    # the caller's URL path is ALREADY percent-encoded (it is what goes
    # on the wire); AWS's canonical URI is that single-encoded path
    canonical_uri = parsed.path or "/"
    # canonical query: sorted by key, values URI-encoded
    q = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(q))
    all_headers = {
        **{k.lower(): v.strip() for k, v in headers.items()},
        "host": parsed.netloc,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
    }
    signed_names = ";".join(sorted(all_headers))
    canonical_headers = "".join(
        f"{k}:{all_headers[k]}\n" for k in sorted(all_headers))
    canonical_request = "\n".join([
        method, canonical_uri, canonical_query, canonical_headers,
        signed_names, payload_hash,
    ])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        _sha256(canonical_request.encode()),
    ])
    k_date = _hmac(b"AWS4" + secret_key.encode(), datestamp)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    auth = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={signature}"
    )
    return {
        "Authorization": auth,
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
    }


def http_error(vendor: str, method: str, url: str,
               e: Exception) -> ObjectStoreError:
    """The store error of a failed request: 5xx, 429 and network errors
    are transient (worth the shared retry), 4xx are not; `http_code`
    carries the status."""
    if isinstance(e, urllib.error.HTTPError):
        if e.code == 404:
            err = ObjectStoreError(f"not found: {url}")
        else:
            err = ObjectStoreError(
                f"{vendor} {method} {url}: HTTP {e.code} {e.read()[:200]!r}")
            err.transient = e.code >= 500 or e.code == 429
        err.http_code = e.code
        return err
    err = ObjectStoreError(f"{vendor} {method} {url}: {e}")
    err.transient = True  # network-shaped: retryable
    return err


class S3Store(ObjectStore):
    """Bucket + key-prefix store over the S3 REST API."""

    name = "s3"

    def __init__(self, bucket: str, prefix: str = "", *,
                 endpoint: Optional[str] = None,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 region: str = "us-east-1"):
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.endpoint = (endpoint
                         or os.environ.get("S3_ENDPOINT")
                         or f"https://s3.{region}.amazonaws.com").rstrip("/")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")
        self.region = region

    # ------------------------------------------------------------ plumbing
    def _key(self, key: str) -> str:
        key = key.lstrip("/")
        return f"{self.prefix}/{key}" if self.prefix else key

    def _url(self, key: str = "", query: str = "") -> str:
        # path-style addressing: endpoint/bucket/key
        path = f"/{self.bucket}"
        if key:
            path += "/" + urllib.parse.quote(self._key(key), safe="/-_.~")
        return self.endpoint + path + (f"?{query}" if query else "")

    def _request(self, method: str, url: str, data: bytes = b"",
                 extra: Optional[dict] = None) -> tuple[bytes, dict]:
        headers = sign_v4(method, url, {}, _sha256(data),
                          self.access_key, self.secret_key, self.region)
        headers.update(extra or {})
        req = urllib.request.Request(url, data=data or None, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.read(), dict(resp.headers)
        except (urllib.error.HTTPError, urllib.error.URLError) as e:
            raise http_error("s3", method, url, e) from None

    # ------------------------------------------------------------- surface
    def _do_read(self, key: str) -> bytes:
        OBJECT_STORE_READS.inc(backend=self.name, outcome="read")
        data = self._request("GET", self._url(key))[0]
        OBJECT_STORE_BYTES.inc(len(data))
        return data

    def _do_read_into(self, key: str, offset: int, buf) -> None:
        n = memoryview(buf).nbytes
        OBJECT_STORE_READS.inc(backend=self.name, outcome="range")
        data = self._request(
            "GET", self._url(key),
            extra={"Range": f"bytes={offset}-{offset + n - 1}"})[0]
        OBJECT_STORE_BYTES.inc(len(data))
        _range_answer(key, data, offset, buf)

    def _do_write(self, key: str, data) -> None:
        self._request("PUT", self._url(key), _joined(data))

    def delete(self, key: str) -> None:
        try:
            self._request("DELETE", self._url(key))
        except ObjectStoreError as e:
            if getattr(e, "http_code", None) != 404:
                raise

    def exists(self, key: str) -> bool:
        try:
            self._request("HEAD", self._url(key))
            return True
        except ObjectStoreError as e:
            if getattr(e, "http_code", None) == 404:
                return False
            raise  # 403 / 5xx / network errors are NOT "does not exist"

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
        return [k[plen:] for k, _ in self._list_with_sizes(full)]

    def _list_with_sizes(self, full_prefix: str) -> list[tuple[str, int]]:
        """ListObjectsV2 with continuation (a minimal XML scrape)."""
        out: list[tuple[str, int]] = []
        token = None
        while True:
            q = ("list-type=2&prefix="
                 + urllib.parse.quote(full_prefix, safe=""))
            if token:
                q += "&continuation-token=" + urllib.parse.quote(token,
                                                                 safe="")
            body = self._request("GET", self._url("", q))[0].decode()
            for m in re.finditer(
                    r"<Contents>.*?<Key>(.*?)</Key>.*?<Size>(\d+)</Size>"
                    r".*?</Contents>", body, re.S):
                # keys come back XML-entity-encoded (& -> &amp;, etc.)
                out.append((html.unescape(m.group(1)), int(m.group(2))))
            t = re.search(r"<NextContinuationToken>(.*?)"
                          r"</NextContinuationToken>", body)
            if not t:
                return out
            token = html.unescape(t.group(1))


def from_url(url: str, **kw) -> ObjectStore:
    """Backend selection by URL scheme: s3://bucket/prefix,
    oss://bucket/prefix (OSS's S3-compatible endpoint), gs://bucket/prefix
    (the GCS XML API)."""
    p = urllib.parse.urlsplit(url)
    bucket, prefix = p.netloc, p.path.strip("/")
    if p.scheme == "s3":
        return S3Store(bucket, prefix, **kw)
    if p.scheme == "oss":
        region = kw.pop("region", os.environ.get("OSS_REGION",
                                                 "oss-cn-hangzhou"))
        kw.setdefault("endpoint", f"https://s3.{region}.aliyuncs.com")
        return S3Store(bucket, prefix, region=region, **kw)
    if p.scheme == "gs":
        kw.setdefault("endpoint", "https://storage.googleapis.com")
        return S3Store(bucket, prefix, **kw)
    raise ObjectStoreError(f"unsupported object store scheme {p.scheme!r}")
