"""Length-prefixed TCP JSON transport: the control-plane fabric.

The port's copy of `elf_tpu/control/transport.py`, same behaviour.

Replaces the reference ZeroMQ DEALER->ROUTER layer
(`src_cpp/elf/distributed/zmq_util.h` +
`shared_rw_buffer2.h`) with a dependency-free socket fabric keeping the
same protocol shape:

 - identity-addressed messages (client identity =
   `<server_id>-<hostname>-<rand>`, shared_rw_buffer2.h:119);
 - client `send(title, body)` -> server dispatches on title
   ({"content", "ctrl"}, Reader::threaded_receive_msg) through a
   ProcessFunc, then a ReplyFunc builds the per-identity reply;
 - the reply returns synchronously on the same connection (the reference's
   request/reply cadence collapses into one round trip — no revokable
   multipart framing needed on a stream socket).

Wire format: 4-byte big-endian length + UTF-8 JSON
{"identity", "title", "body"}; reply {"ok", "reply"}.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import uuid
from typing import Callable, Optional

from elf_tpu_torch.logging_utils import get_indexed_logger

_HDR = struct.Struct(">I")
MAX_MSG = 512 * 1024 * 1024


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_msg(sock: socket.socket) -> Optional[dict]:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    if n > MAX_MSG:
        raise ValueError(f"message too large: {n}")
    data = _recv_exact(sock, n)
    if data is None:
        return None
    return json.loads(data.decode())


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def make_identity(server_id: str = "go") -> str:
    return f"{server_id}-{socket.gethostname()}-{uuid.uuid4().hex[:8]}"


class ControlServer:
    """Threaded request/reply server (shared::Reader equivalent).

    process_fn(identity, title, body) -> None (ingest)
    reply_fn(identity, title) -> reply body (str or dict)
    """

    def __init__(
        self,
        port: int,
        process_fn: Callable[[str, str, str], None],
        reply_fn: Callable[[str], object],
        host: str = "0.0.0.0",
    ):
        self.logger = get_indexed_logger("control.Server-")
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        msg = _recv_msg(self.request)
                        if msg is None:
                            return
                        identity = msg.get("identity", "?")
                        try:
                            outer.process_fn(
                                identity, msg.get("title", ""), msg.get("body", "")
                            )
                            reply = outer.reply_fn(
                                identity, msg.get("title", "")
                            )
                            _send_msg(self.request, {"ok": True, "reply": reply})
                        except Exception as e:  # noqa: BLE001
                            outer.logger.exception("handler error")
                            _send_msg(self.request, {"ok": False, "reply": str(e)})
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.process_fn = process_fn
        self.reply_fn = reply_fn
        self.server = Server((host, port), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )

    def start(self) -> None:
        self.thread.start()
        self.logger.info("control server listening on :%d", self.port)

    def stop(self) -> None:
        # shutdown() blocks forever unless serve_forever() is running; if
        # start() was never called (or the thread already died) just close
        # the listening socket.
        if self.thread.is_alive():
            self.server.shutdown()
        self.server.server_close()


class ControlClient:
    """Persistent-connection client (shared::Writer equivalent)."""

    def __init__(self, addr: str, port: int, identity: Optional[str] = None,
                 timeout: float = 60.0):
        self.addr = addr
        self.port = port
        self.identity = identity or make_identity()
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self.lock = threading.Lock()
        self.logger = get_indexed_logger("control.Client-")

    def _connect(self) -> None:
        self.sock = socket.create_connection(
            (self.addr, self.port), timeout=self.timeout
        )

    def send(self, title: str, body: str) -> Optional[object]:
        """Send and return the server's reply body (None on failure)."""
        with self.lock:
            for attempt in range(2):
                try:
                    if self.sock is None:
                        self._connect()
                    _send_msg(self.sock, {
                        "identity": self.identity, "title": title, "body": body,
                    })
                    resp = _recv_msg(self.sock)
                    if resp is None:
                        raise ConnectionError("server closed connection")
                    return resp.get("reply")
                except (ConnectionError, OSError, socket.timeout) as e:
                    self.logger.warning("send failed (%s), attempt %d", e, attempt)
                    try:
                        if self.sock:
                            self.sock.close()
                    finally:
                        self.sock = None
            return None

    def close(self) -> None:
        with self.lock:
            if self.sock:
                self.sock.close()
                self.sock = None
