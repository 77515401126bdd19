"""Arrow Flight's protobuf messages (format/Flight.proto of Apache Arrow)
over `utils/protowire.py`, and the service's method paths.

Each message is a small dataclass with `encode()` and a `decode(bytes)`
classmethod; fields left at their proto3 default are not written, and
unknown fields are skipped on reading. `FlightData` carries an Arrow IPC
message: `data_header` is its flatbuffer header and `data_body` its body
(`datasource/arrow_ipc.py`); the first message of a DoPut also carries
the descriptor. `FlightInfo.schema` is an encapsulated Schema message.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from greptimedb_tpu_torch.utils.protowire import (
    field_bytes,
    field_str,
    field_varint,
    iter_fields,
    varint_to_sint64,
)

SERVICE = "/arrow.flight.protocol.FlightService/"
HANDSHAKE = SERVICE + "Handshake"
LIST_FLIGHTS = SERVICE + "ListFlights"
GET_FLIGHT_INFO = SERVICE + "GetFlightInfo"
GET_SCHEMA = SERVICE + "GetSchema"
DO_GET = SERVICE + "DoGet"
DO_PUT = SERVICE + "DoPut"
DO_ACTION = SERVICE + "DoAction"
LIST_ACTIONS = SERVICE + "ListActions"

#: the metadata key the Flight handshake's token rides in
AUTH_TOKEN = "auth-token-bin"


def _bytes(v) -> bytes:
    return bytes(v) if not isinstance(v, bytes) else v


@dataclass
class HandshakeRequest:
    protocol_version: int = 0
    payload: bytes = b""

    def encode(self) -> bytes:
        out = b""
        if self.protocol_version:
            out += field_varint(1, self.protocol_version)
        if self.payload:
            out += field_bytes(2, self.payload)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "HandshakeRequest":
        m = cls()
        for f, _wt, v in iter_fields(data):
            if f == 1:
                m.protocol_version = v
            elif f == 2:
                m.payload = _bytes(v)
        return m


#: HandshakeResponse has HandshakeRequest's fields
HandshakeResponse = HandshakeRequest


@dataclass
class Ticket:
    ticket: bytes = b""

    def encode(self) -> bytes:
        return field_bytes(1, self.ticket) if self.ticket else b""

    @classmethod
    def decode(cls, data: bytes) -> "Ticket":
        m = cls()
        for f, _wt, v in iter_fields(data):
            if f == 1:
                m.ticket = _bytes(v)
        return m


@dataclass
class FlightDescriptor:
    UNKNOWN, PATH, CMD = 0, 1, 2

    type: int = 0
    cmd: bytes = b""
    path: list = field(default_factory=list)

    @classmethod
    def for_path(cls, *path: str) -> "FlightDescriptor":
        return cls(cls.PATH, b"", [str(p) for p in path])

    def encode(self) -> bytes:
        out = field_varint(1, self.type) if self.type else b""
        if self.cmd:
            out += field_bytes(2, self.cmd)
        for p in self.path:
            out += field_str(3, p)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "FlightDescriptor":
        m = cls()
        for f, _wt, v in iter_fields(data):
            if f == 1:
                m.type = v
            elif f == 2:
                m.cmd = _bytes(v)
            elif f == 3:
                m.path.append(_bytes(v).decode())
        return m


@dataclass
class FlightData:
    descriptor: Optional[FlightDescriptor] = None
    data_header: bytes = b""
    app_metadata: bytes = b""
    data_body: bytes = b""

    def encode(self) -> bytes:
        out = b""
        if self.descriptor is not None:
            out += field_bytes(1, self.descriptor.encode())
        if self.data_header:
            out += field_bytes(2, self.data_header)
        if self.app_metadata:
            out += field_bytes(3, self.app_metadata)
        if self.data_body:
            out += field_bytes(1000, self.data_body)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "FlightData":
        m = cls()
        for f, _wt, v in iter_fields(memoryview(data)):
            if f == 1:
                m.descriptor = FlightDescriptor.decode(_bytes(v))
            elif f == 2:
                m.data_header = v
            elif f == 3:
                m.app_metadata = _bytes(v)
            elif f == 1000:
                m.data_body = v
        return m


@dataclass
class PutResult:
    app_metadata: bytes = b""

    def encode(self) -> bytes:
        return field_bytes(1, self.app_metadata) if self.app_metadata \
            else b""

    @classmethod
    def decode(cls, data: bytes) -> "PutResult":
        m = cls()
        for f, _wt, v in iter_fields(data):
            if f == 1:
                m.app_metadata = _bytes(v)
        return m


@dataclass
class Action:
    type: str = ""
    body: bytes = b""

    def encode(self) -> bytes:
        out = field_str(1, self.type) if self.type else b""
        if self.body:
            out += field_bytes(2, self.body)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Action":
        m = cls()
        for f, _wt, v in iter_fields(data):
            if f == 1:
                m.type = _bytes(v).decode()
            elif f == 2:
                m.body = _bytes(v)
        return m


@dataclass
class Result:
    body: bytes = b""

    def encode(self) -> bytes:
        return field_bytes(1, self.body) if self.body else b""

    @classmethod
    def decode(cls, data: bytes) -> "Result":
        m = cls()
        for f, _wt, v in iter_fields(data):
            if f == 1:
                m.body = _bytes(v)
        return m


@dataclass
class ActionType:
    type: str = ""
    description: str = ""

    def encode(self) -> bytes:
        out = field_str(1, self.type) if self.type else b""
        if self.description:
            out += field_str(2, self.description)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ActionType":
        m = cls()
        for f, _wt, v in iter_fields(data):
            if f == 1:
                m.type = _bytes(v).decode()
            elif f == 2:
                m.description = _bytes(v).decode()
        return m


@dataclass
class Criteria:
    expression: bytes = b""

    def encode(self) -> bytes:
        return field_bytes(1, self.expression) if self.expression else b""

    @classmethod
    def decode(cls, data: bytes) -> "Criteria":
        m = cls()
        for f, _wt, v in iter_fields(data):
            if f == 1:
                m.expression = _bytes(v)
        return m


@dataclass
class FlightEndpoint:
    ticket: Optional[Ticket] = None
    locations: list = field(default_factory=list)  # URIs
    app_metadata: bytes = b""

    def encode(self) -> bytes:
        out = b""
        if self.ticket is not None:
            out += field_bytes(1, self.ticket.encode())
        for uri in self.locations:
            out += field_bytes(2, field_str(1, uri))
        if self.app_metadata:
            out += field_bytes(4, self.app_metadata)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "FlightEndpoint":
        m = cls()
        for f, _wt, v in iter_fields(data):
            if f == 1:
                m.ticket = Ticket.decode(_bytes(v))
            elif f == 2:
                for lf, _lw, lv in iter_fields(_bytes(v)):
                    if lf == 1:
                        m.locations.append(_bytes(lv).decode())
            elif f == 4:
                m.app_metadata = _bytes(v)
        return m


@dataclass
class FlightInfo:
    schema: bytes = b""
    descriptor: Optional[FlightDescriptor] = None
    endpoints: list = field(default_factory=list)
    total_records: int = -1
    total_bytes: int = -1
    ordered: bool = False
    app_metadata: bytes = b""

    def encode(self) -> bytes:
        out = field_bytes(1, self.schema) if self.schema else b""
        if self.descriptor is not None:
            out += field_bytes(2, self.descriptor.encode())
        for ep in self.endpoints:
            out += field_bytes(3, ep.encode())
        if self.total_records:
            out += field_varint(4, self.total_records)
        if self.total_bytes:
            out += field_varint(5, self.total_bytes)
        if self.ordered:
            out += field_varint(6, 1)
        if self.app_metadata:
            out += field_bytes(7, self.app_metadata)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "FlightInfo":
        m = cls(total_records=0, total_bytes=0)
        for f, _wt, v in iter_fields(data):
            if f == 1:
                m.schema = _bytes(v)
            elif f == 2:
                m.descriptor = FlightDescriptor.decode(_bytes(v))
            elif f == 3:
                m.endpoints.append(FlightEndpoint.decode(_bytes(v)))
            elif f == 4:
                m.total_records = varint_to_sint64(v)
            elif f == 5:
                m.total_bytes = varint_to_sint64(v)
            elif f == 6:
                m.ordered = bool(v)
            elif f == 7:
                m.app_metadata = _bytes(v)
        return m
