"""A minimal HTTP/1.1 and WebSocket (RFC 6455) server on asyncio.

It takes the place of ``aiohttp.web`` for the port's ``web.py`` and
``pose_server.py`` (the card's machine has no ``aiohttp``), and does
only what they use:

- ``GET`` routes answering with a file, JSON or text, 404 for unknown
  paths and 405 for other methods; one request per connection
  (``Connection: close``);
- the WebSocket upgrade (``Sec-WebSocket-Accept`` is base64 of SHA-1 of
  the client's key and the RFC's GUID), then unmasked server text and
  binary frames with 7-, 16- and 64-bit lengths, never fragmented;
  masked client frames read, a ping answered with a pong, a close
  answered with a close, inbound messages handed to the route whole (a
  fragmented message's frames joined, as ``aiohttp`` joins them).

No TLS, no extensions (an offered ``permessage-deflate`` is declined by
leaving it out of the answer), no keep-alive, no fragmented sends.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import struct
from typing import Awaitable, Callable, Dict, NamedTuple, Optional, Set

log = logging.getLogger(__name__)

WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_WS_FRAME = 16 * 1024 * 1024     # inbound guard on a frame and a message

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA

_REASONS = {200: "OK", 101: "Switching Protocols", 400: "Bad Request",
            404: "Not Found", 405: "Method Not Allowed"}


def ws_accept_key(key: str) -> str:
    """The ``Sec-WebSocket-Accept`` value for a client's key."""
    return base64.b64encode(
        hashlib.sha1(key.encode("ascii") + WS_GUID).digest()).decode()


def ws_frame(opcode: int, payload: bytes) -> bytes:
    """One final (FIN), unmasked frame: a server's."""
    n = len(payload)
    if n < 126:
        head = bytes([0x80 | opcode, n])
    elif n < 1 << 16:
        head = bytes([0x80 | opcode, 126]) + struct.pack(">H", n)
    else:
        head = bytes([0x80 | opcode, 127]) + struct.pack(">Q", n)
    return head + payload


def _unmask(data: bytes, mask: bytes) -> bytes:
    """XOR with the repeated 4-byte mask (its own inverse)."""
    if not data:
        return data
    key = int.from_bytes((mask * (len(data) // 4 + 1))[:len(data)], "big")
    return (int.from_bytes(data, "big") ^ key).to_bytes(len(data), "big")


async def read_ws_frame(reader: asyncio.StreamReader):
    """One frame from ``reader``: (fin, opcode, payload), unmasked."""
    b0, b1 = await reader.readexactly(2)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack(">Q", await reader.readexactly(8))
    if n > MAX_WS_FRAME:
        raise ValueError(f"WebSocket frame of {n} bytes")
    mask = await reader.readexactly(4) if b1 & 0x80 else None
    payload = await reader.readexactly(n)
    if mask is not None:
        payload = _unmask(payload, mask)
    return bool(b0 & 0x80), b0 & 0x0F, payload


class Response(NamedTuple):
    status: int
    body: bytes
    content_type: str = "text/plain; charset=utf-8"


def json_response(data) -> Response:
    return Response(200, json.dumps(data).encode(), "application/json")


def file_response(path: str, content_type: str = "text/html") -> Response:
    with open(path, "rb") as f:
        return Response(200, f.read(), content_type)


class Request(NamedTuple):
    method: str
    path: str
    headers: Dict[str, str]       # lower-cased names
    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter

    @property
    def is_websocket(self) -> bool:
        return (self.headers.get("upgrade", "").lower() == "websocket"
                and "sec-websocket-key" in self.headers)


class WebSocket:
    """The server side of one WebSocket connection."""

    def __init__(self, request: Request):
        self._reader = request.reader
        self._writer = request.writer
        self.closed = False

    async def _send(self, opcode: int, payload: bytes) -> None:
        if self.closed:
            raise ConnectionResetError("WebSocket is closed")
        self._writer.write(ws_frame(opcode, payload))
        await self._writer.drain()

    async def send_str(self, text: str) -> None:
        await self._send(OP_TEXT, text.encode("utf-8"))

    async def send_bytes(self, data: bytes) -> None:
        await self._send(OP_BINARY, bytes(data))

    async def close(self, code: int = 1000) -> None:
        if not self.closed:
            try:
                await self._send(OP_CLOSE, struct.pack(">H", code))
            except (ConnectionError, RuntimeError):
                pass
            self.closed = True

    async def receive(self):
        """The next inbound message as (opcode, payload), a fragmented
        one joined (its first frame's opcode, then continuation frames
        up to the final one; pings and pongs may come between them); None
        once the client closed or the connection ended. Pings are
        answered, pongs ignored and a close echoed on the way. A
        continuation without a message to
        continue, a new message inside one or a message over
        MAX_WS_FRAME bytes closes the connection (1002, 1002, 1009)."""
        first, parts, size = None, [], 0
        while not self.closed:
            try:
                fin, op, payload = await read_ws_frame(self._reader)
            except (asyncio.IncompleteReadError, ConnectionError,
                    ValueError):
                self.closed = True
                return None
            if op == OP_PING:
                await self._send(OP_PONG, payload)
                continue
            if op == OP_PONG:
                continue
            if op == OP_CLOSE:
                await self.close(struct.unpack(">H", payload[:2])[0]
                                 if len(payload) >= 2 else 1000)
                return None
            if (op == OP_CONT) != (first is not None) \
                    or op not in (OP_CONT, OP_TEXT, OP_BINARY):
                await self.close(1002)
                return None
            first = op if first is None else first
            parts.append(payload)
            size += len(payload)
            if size > MAX_WS_FRAME:
                await self.close(1009)
                return None
            if fin:
                return first, b"".join(parts)
        return None

    def __aiter__(self):
        return self

    async def __anext__(self):
        msg = await self.receive()
        if msg is None:
            raise StopAsyncIteration
        return msg


Handler = Callable[[Request], Awaitable[Optional[Response]]]


class HttpServer:
    """Routes ``GET`` paths to handlers. A handler returns a Response,
    or calls ``await self.upgrade(request)`` and serves the WebSocket
    it gets until it returns None."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.host = host
        self.port = port
        self.routes: Dict[str, Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: Set[asyncio.Task] = set()

    def add_get(self, path: str, handler: Handler) -> None:
        self.routes[path] = handler

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)

    @property
    def bound_port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        """Stop listening and end every open connection."""
        if self._server is None:
            return
        self._server.close()
        conns = list(self._conns)
        for t in conns:
            t.cancel()
        await asyncio.gather(*conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    @staticmethod
    async def upgrade(request: Request) -> WebSocket:
        """Answer the WebSocket handshake; returns the open socket."""
        accept = ws_accept_key(request.headers["sec-websocket-key"])
        request.writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
            b"Connection: Upgrade\r\nSec-WebSocket-Accept: "
            + accept.encode() + b"\r\n\r\n")
        await request.writer.drain()
        return WebSocket(request)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            req = await self._read_request(reader, writer)
            if req is None:
                return
            if req.method != "GET":
                resp = Response(405, b"405: Method Not Allowed")
            elif req.path not in self.routes:
                resp = Response(404, b"404: Not Found")
            else:
                resp = await self.routes[req.path](req)
            if resp is not None:
                writer.write(
                    b"HTTP/1.1 %d %s\r\nContent-Type: %s\r\n"
                    b"Content-Length: %d\r\nConnection: close\r\n\r\n"
                    % (resp.status, _REASONS.get(resp.status, "").encode(),
                       resp.content_type.encode(), len(resp.body))
                    + resp.body)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:
            log.exception("HTTP handler failed")
        finally:
            self._conns.discard(task)
            writer.close()

    @staticmethod
    async def _read_request(reader, writer) -> Optional[Request]:
        try:       # the reader's limit (64 KiB) bounds the header
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.LimitOverrunError, asyncio.IncompleteReadError):
            return None
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3:
            return None
        headers = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        path = parts[1].split("?", 1)[0]
        return Request(parts[0].upper(), path, headers, reader, writer)

