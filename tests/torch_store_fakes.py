"""In-process fakes of S3, GCS and Azure Blob for the port's object-store
tests (the fakes of tests/test_objectstore_s3.py and
tests/test_objectstore_cloud.py, extended with `Range` reads and request
counts). One fake serves the JAX package's store and the port's at the
same time: each signs with the shared secret, and the fake recomputes
SigV4 / SharedKey with the JAX package's signer.

`serve(kind)` starts a fake on 127.0.0.1:0 and returns it; `close()`
shuts it down and joins its threads. `objects` maps bucket-relative keys
to bytes; `requests` lists (verb, key, range) of every request served.
"""

import json
import re
import threading
import urllib.parse
import xml.sax.saxutils as sx
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

S3_ACCESS, S3_SECRET, S3_REGION = "AKIDEXAMPLE", "sekret", "us-east-1"
GCS_TOKEN = "test-bearer-token"
AZ_ACCOUNT, AZ_KEY = "devacct", "c2VjcmV0LWtleS1ieXRlcw=="


class _Base(BaseHTTPRequestHandler):
    fake = None  # the Fake this handler serves (set per server)

    def log_message(self, *a):
        pass

    def _send(self, code, body=b"", headers=None, length=None):
        self.send_response(code)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length",
                         str(len(body) if length is None else length))
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def _record(self, verb, key):
        with self.fake.lock:
            self.fake.requests.append((verb, key,
                                       self.headers.get("Range")))

    def _object(self, key, verb="GET"):
        """GET / HEAD of an object, honouring a Range header."""
        data = self.fake.objects.get(key)
        if data is None:
            return self._send(404)
        self._record(verb, key)
        if verb == "HEAD":
            return self._send(200, length=len(data))
        rng = self.headers.get("Range")
        if rng:
            m = re.fullmatch(r"bytes=(\d+)-(\d+)", rng)
            a, b = int(m.group(1)), int(m.group(2))
            return self._send(206, data[a:b + 1], {
                "Content-Range": f"bytes {a}-{b}/{len(data)}"})
        return self._send(200, data)


class _S3(_Base):
    page_size = 2

    def _signed(self) -> bool:
        import datetime

        from greptimedb_tpu.objectstore.s3 import sign_v4

        try:
            now = datetime.datetime.strptime(
                self.headers.get("x-amz-date", ""), "%Y%m%dT%H%M%SZ"
            ).replace(tzinfo=datetime.timezone.utc)
        except ValueError:
            return False
        url = f"http://{self.headers['Host']}{self.path}"
        want = sign_v4(self.command, url, {},
                       self.headers.get("x-amz-content-sha256", ""),
                       S3_ACCESS, S3_SECRET, S3_REGION, now=now)
        return want["Authorization"] == self.headers.get("Authorization")

    def _route(self):
        body = b""
        if self.command == "PUT":
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
        if not self._signed():
            return self._send(403, b"<Error>SignatureDoesNotMatch</Error>")
        parsed = urllib.parse.urlsplit(self.path)
        q = dict(urllib.parse.parse_qsl(parsed.query))
        parts = parsed.path.lstrip("/").split("/", 1)
        key = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
        objects = self.fake.objects
        if self.command == "PUT":
            objects[key] = body
            self._record("PUT", key)
            return self._send(200)
        if self.command == "DELETE":
            objects.pop(key, None)
            self._record("DELETE", key)
            return self._send(204)
        if self.command == "GET" and q.get("list-type") == "2":
            prefix = q.get("prefix", "")
            start = q.get("continuation-token", "")
            keys = sorted(k for k in objects
                          if k.startswith(prefix) and k > start)
            page, rest = keys[:self.page_size], keys[self.page_size:]
            xml = "<ListBucketResult>" + "".join(
                f"<Contents><Key>{sx.escape(k)}</Key>"
                f"<Size>{len(objects[k])}</Size></Contents>" for k in page)
            if rest:
                xml += (f"<NextContinuationToken>{sx.escape(page[-1])}"
                        "</NextContinuationToken>")
            self._record("LIST", prefix)
            return self._send(200, (xml + "</ListBucketResult>").encode())
        return self._object(key, self.command)

    do_GET = do_PUT = do_DELETE = do_HEAD = _route


class _Gcs(_Base):
    page_size = 2

    def _name(self):
        path = urllib.parse.urlsplit(self.path).path
        parts = path.split("/o/", 1)
        return urllib.parse.unquote(parts[1]) if len(parts) == 2 else None

    def do_GET(self):
        if self.headers.get("Authorization") != f"Bearer {GCS_TOKEN}":
            return self._send(401)
        q = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
        name = self._name()
        objects = self.fake.objects
        if name is None:
            prefix = q.get("prefix", [""])[0]
            keys = sorted(k for k in objects if k.startswith(prefix))
            start = int(q.get("pageToken", ["0"])[0] or 0)
            page = keys[start:start + self.page_size]
            body = {"items": [{"name": k, "size": len(objects[k])}
                              for k in page]}
            if start + self.page_size < len(keys):
                body["nextPageToken"] = str(start + self.page_size)
            self._record("LIST", prefix)
            return self._send(200, json.dumps(body).encode())
        if q.get("alt", [""])[0] == "media":
            return self._object(name)
        if name not in objects:
            return self._send(404)
        self._record("META", name)
        return self._send(200, json.dumps(
            {"name": name, "size": str(len(objects[name]))}).encode())

    def do_POST(self):
        if self.headers.get("Authorization") != f"Bearer {GCS_TOKEN}":
            return self._send(401)
        q = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
        name = q.get("name", [None])[0]
        self.fake.objects[name] = self.rfile.read(
            int(self.headers.get("Content-Length", 0)))
        self._record("PUT", name)
        return self._send(200, json.dumps({"name": name}).encode())

    def do_DELETE(self):
        if self.headers.get("Authorization") != f"Bearer {GCS_TOKEN}":
            return self._send(401)
        name = self._name()
        if name not in self.fake.objects:
            return self._send(404)
        del self.fake.objects[name]
        self._record("DELETE", name)
        return self._send(204)


class _Azblob(_Base):
    page_size = 2

    def _auth(self) -> bool:
        from greptimedb_tpu.objectstore.azblob import sign_shared_key

        headers = dict(self.headers.items())
        url = f"http://{self.headers['Host']}{self.path}"
        return self.headers.get("Authorization", "") == sign_shared_key(
            self.command, url, headers, AZ_ACCOUNT, AZ_KEY)

    def _name(self):
        path = urllib.parse.urlsplit(self.path).path
        parts = path.lstrip("/").split("/", 1)
        return urllib.parse.unquote(parts[1]) if len(parts) == 2 else None

    def do_GET(self):
        if not self._auth():
            return self._send(403)
        q = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
        objects = self.fake.objects
        if q.get("comp", [""])[0] == "list":
            prefix = q.get("prefix", [""])[0]
            keys = sorted(k for k in objects if k.startswith(prefix))
            start = int(q.get("marker", ["0"])[0] or 0)
            page = keys[start:start + self.page_size]
            nxt = str(start + self.page_size) \
                if start + self.page_size < len(keys) else ""
            xml = ("<?xml version='1.0'?><EnumerationResults><Blobs>"
                   + "".join(f"<Blob><Name>{sx.escape(k)}</Name></Blob>"
                             for k in page)
                   + f"</Blobs><NextMarker>{nxt}</NextMarker>"
                   "</EnumerationResults>")
            self._record("LIST", prefix)
            return self._send(200, xml.encode())
        return self._object(self._name())

    def do_HEAD(self):
        if not self._auth():
            return self._send(403)
        return self._object(self._name(), "HEAD")

    def do_PUT(self):
        if not self._auth():
            return self._send(403)
        name = self._name()
        self.fake.objects[name] = self.rfile.read(
            int(self.headers.get("Content-Length", 0)))
        self._record("PUT", name)
        return self._send(201)

    def do_DELETE(self):
        if not self._auth():
            return self._send(403)
        name = self._name()
        if name not in self.fake.objects:
            return self._send(404)
        del self.fake.objects[name]
        self._record("DELETE", name)
        return self._send(202)


class Fake:
    def __init__(self, handler):
        self.objects: dict = {}
        self.requests: list = []
        self.lock = threading.Lock()
        cls = type("Handler", (handler,), {"fake": self})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), cls)
        self.httpd.daemon_threads = False
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       name="test-fake-store")
        self.thread.start()
        self.endpoint = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def verbs(self) -> list:
        with self.lock:
            return [r[0] for r in self.requests]

    def close(self) -> None:
        self.httpd.shutdown()
        self.thread.join()
        self.httpd.server_close()


def serve(kind: str) -> Fake:
    return Fake({"s3": _S3, "gcs": _Gcs, "azblob": _Azblob}[kind])


def store_kwargs(kind: str, fake: Fake, prefix: str) -> dict:
    """Constructor arguments of either package's store against `fake`."""
    if kind == "s3":
        return dict(bucket="bkt", prefix=prefix, endpoint=fake.endpoint,
                    access_key=S3_ACCESS, secret_key=S3_SECRET,
                    region=S3_REGION)
    if kind == "gcs":
        return dict(bucket="bkt", prefix=prefix, endpoint=fake.endpoint,
                    token=GCS_TOKEN)
    return dict(container="ctr", prefix=prefix, endpoint=fake.endpoint,
                account_name=AZ_ACCOUNT, account_key=AZ_KEY)
