"""TCP bus: the file bus served over sockets — a real networked
transport for multi-host deployments with no shared filesystem.

The reference runs its topics on Kafka (framework/kafka-util/.../
KafkaUtils.java:57-152). This module provides the deployment shape that
matters from that: ONE host runs a bus server (`serve()`, or
``python -m oryx_tpu_torch bus-serve``) holding the topic logs in its local
FileBroker; every layer process — on any host — speaks ``tcp://host:port``
through :class:`NetBroker`, which implements the full Broker SPI
(produce, consume-with-groups, offset ledger, admin). Offsets live in
the server's ledger, so consumer groups resume across client restarts
exactly like the file bus (and like Kafka consumer groups).

Wire protocol (deliberately minimal, length-prefixed):
  request  = u32 header_len | header JSON | u32 payload_len | payload
  response = same shape; header {"ok": bool, "error": str?, ...}
Payloads carry batched records in the file bus's tab-framed line format
(one encode shared with the on-disk segments), so the server's produce
path is a single append and the consumer's poll_block fast path is the
same vectorized splitter the file consumer uses.

A Kafka adapter proper (kafka-python client API) lives in
``oryx_tpu_torch.bus.kafkabus`` for sites that already run Kafka.

Port note: a copy of ``oryx_tpu/bus/netbus.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import json
import logging
import socket
import socketserver
import struct
import threading
import time
from typing import Iterable

from oryx_tpu_torch.bus.core import Broker, KeyMessage, TopicConsumer, TopicProducer
from oryx_tpu_torch.common import metrics

log = logging.getLogger(__name__)

_MAX_FRAME = 256 * 1024 * 1024


def _send_frame(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    h = json.dumps(header).encode("utf-8")
    sock.sendall(struct.pack(">II", len(h), len(payload)) + h + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> tuple[dict, bytes]:
    hlen, plen = struct.unpack(">II", _recv_exact(sock, 8))
    if hlen > _MAX_FRAME or plen > _MAX_FRAME:
        raise ConnectionError(f"oversized frame ({hlen}/{plen})")
    header = json.loads(_recv_exact(sock, hlen)) if hlen else {}
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class _Handler(socketserver.BaseRequestHandler):
    """One connection = one client session. Consumers opened on this
    connection are owned by it and torn down when it drops (a crashed
    client leaks nothing server-side)."""

    def handle(self) -> None:  # noqa: C901 - a flat op switch
        broker = self.server.broker  # type: ignore[attr-defined]
        consumers: dict[int, TopicConsumer] = {}
        next_cid = 0
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                try:
                    req, payload = _recv_frame(sock)
                except (ConnectionError, struct.error):
                    return
                op = req.get("op")
                try:
                    if op == "produce":
                        # payload: tab-framed lines, one per record
                        from oryx_tpu_torch.bus.blockcodec import decode_wire_lines

                        records = decode_wire_lines(payload)
                        with broker.producer(req["topic"]) as p:
                            n = p.send_many(records)
                        _send_frame(sock, {"ok": True, "n": n})
                    elif op == "consumer_open":
                        cid = next_cid
                        next_cid += 1
                        consumers[cid] = broker.consumer(
                            req["topic"],
                            group=req.get("group"),
                            from_beginning=bool(req.get("from_beginning")),
                        )
                        _send_frame(sock, {"ok": True, "cid": cid})
                    elif op == "poll":
                        c = consumers[req["cid"]]
                        block = c.poll_block(
                            max_records=int(req.get("max_records", 1000)),
                            timeout=float(req.get("timeout", 0.1)),
                        )
                        from oryx_tpu_torch.bus.blockcodec import encode_block_lines

                        blob = encode_block_lines(block) if block is not None else b""
                        _send_frame(
                            sock,
                            {
                                "ok": True,
                                "n": 0 if block is None else len(block),
                                # positions ride along so the client can
                                # restore this consumer after a reconnect
                                "positions": {str(k): v for k, v in c.positions().items()},
                            },
                            blob,
                        )
                    elif op == "commit":
                        consumers[req["cid"]].commit()
                        _send_frame(sock, {"ok": True})
                    elif op == "seek":
                        consumers[req["cid"]].seek(
                            {int(k): int(v) for k, v in req["positions"].items()}
                        )
                        _send_frame(sock, {"ok": True})
                    elif op == "positions":
                        pos = consumers[req["cid"]].positions()
                        _send_frame(sock, {"ok": True, "positions": {str(k): v for k, v in pos.items()}})
                    elif op == "consumer_close":
                        c = consumers.pop(req["cid"], None)
                        if c is not None:
                            c.close()
                        _send_frame(sock, {"ok": True})
                    elif op == "create_topic":
                        broker.create_topic(
                            req["topic"], int(req.get("partitions", 1)), req.get("config")
                        )
                        _send_frame(sock, {"ok": True})
                    elif op == "topic_exists":
                        _send_frame(sock, {"ok": True, "exists": broker.topic_exists(req["topic"])})
                    elif op == "delete_topic":
                        broker.delete_topic(req["topic"])
                        _send_frame(sock, {"ok": True})
                    elif op == "get_offsets":
                        offs = broker.get_offsets(req["group"], req["topic"])
                        _send_frame(sock, {"ok": True, "offsets": {str(k): v for k, v in offs.items()}})
                    elif op == "set_offsets":
                        broker.set_offsets(
                            req["group"], req["topic"],
                            {int(k): int(v) for k, v in req["offsets"].items()},
                        )
                        _send_frame(sock, {"ok": True})
                    elif op == "latest_offsets":
                        offs = broker.latest_offsets(req["topic"])
                        _send_frame(sock, {"ok": True, "offsets": {str(k): v for k, v in offs.items()}})
                    elif op == "ping":
                        _send_frame(sock, {"ok": True})
                    else:
                        _send_frame(sock, {"ok": False, "error": f"unknown op {op!r}"})
                except Exception as e:  # noqa: BLE001 - reported to client
                    log.warning("bus-serve op %s failed", op, exc_info=True)
                    try:
                        _send_frame(sock, {"ok": False, "error": f"{type(e).__name__}: {e}"})
                    except OSError:
                        return
        finally:
            for c in consumers.values():
                try:
                    c.close()
                except Exception:  # noqa: BLE001
                    pass


class BusServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address: tuple[str, int], data_dir: str) -> None:
        super().__init__(address, _Handler)
        from oryx_tpu_torch.bus.filebus import FileBroker

        self.broker = FileBroker(data_dir)
        self._client_socks: set = set()
        self._client_lock = threading.Lock()
        self._serve_thread: threading.Thread | None = None

    def shutdown(self):
        super().shutdown()
        # reap the background serve_forever thread started by serve();
        # shutdown() returns only after the loop exits, so this is quick
        t, self._serve_thread = self._serve_thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    # live-connection tracking: server_close() must sever established
    # client connections too, not just the listener — otherwise a
    # "stopped" server keeps serving through old handler threads and
    # clients never exercise their reconnect path
    def process_request(self, request, client_address):
        with self._client_lock:
            self._client_socks.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._client_lock:
            self._client_socks.discard(request)
        super().shutdown_request(request)

    def server_close(self):
        super().server_close()
        with self._client_lock:
            socks = list(self._client_socks)
            self._client_socks.clear()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


def serve(host: str, port: int, data_dir: str) -> BusServer:
    """Start a bus server on a background thread; returns the server
    (call ``.shutdown()`` to stop). Blocking use: ``serve_forever`` on
    the returned object, which is what the CLI does."""
    server = BusServer((host, port), data_dir)
    t = threading.Thread(target=server.serve_forever, name="oryx-bus-serve", daemon=True)
    server._serve_thread = t
    t.start()
    log.info("bus server on %s:%d over %s", host, server.server_address[1], data_dir)
    return server


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


DEFAULT_CONNECT_TIMEOUT = 30.0


class _Conn:
    """One socket. The broker serializes requests per channel (strict
    request/response protocol) and owns reconnection, so this class is
    deliberately dumb: callers must hold the owning channel's lock."""

    def __init__(self, host: str, port: int, connect_timeout: float) -> None:
        self._host, self._port = host, port
        self._connect_timeout = connect_timeout
        self._sock: socket.socket | None = None

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def connect(self) -> None:
        self.drop()
        sock = socket.create_connection((self._host, self._port), timeout=self._connect_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock

    def call(self, header: dict, payload: bytes = b"") -> tuple[dict, bytes]:
        if self._sock is None:
            raise ConnectionError("not connected")
        try:
            _send_frame(self._sock, header, payload)
            resp, body = _recv_frame(self._sock)
        except (ConnectionError, OSError, struct.error):
            self.drop()
            raise
        if not resp.get("ok"):
            # a server-side op error: the connection itself is fine
            raise RuntimeError(f"bus server error: {resp.get('error')}")
        return resp, body

    def drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        self.drop()


class _NetProducer(TopicProducer):
    def __init__(self, broker: "NetBroker", topic: str) -> None:
        self._broker = broker
        self._topic = topic

    @property
    def update_broker(self) -> str:
        return self._broker.locator()

    @property
    def topic(self) -> str:
        return self._topic

    def send(self, key: str | None, message: str) -> None:
        self.send_many([(key, message)])

    def send_many(self, records: Iterable[tuple[str | None, str]]) -> int:
        from oryx_tpu_torch.bus.blockcodec import encode_wire_lines

        n = 0
        # ship in bounded slices so one huge publish (a model) streams.
        # A slice retried after a reconnect may already have landed
        # server-side: at-least-once, like every broker here.
        for blob, count in encode_wire_lines(records, slice_bytes=8 << 20):
            self._broker._invoke(lambda: {"op": "produce", "topic": self._topic}, blob)
            n += count
        return n

    def close(self) -> None:
        pass


class _NetConsumer(TopicConsumer):
    """Client-side consumer handle over its own dedicated connection.

    A server-side poll blocks its connection for up to the poll timeout;
    on a shared socket that block would also stall every producer and
    admin call made through the same broker handle. Each consumer
    therefore owns a private socket and lock — its blocking polls never
    serialize against the broker's shared channel or other consumers.

    The handle remembers how it was opened and its last server-reported
    positions so the broker can transparently reopen and re-seek it after
    a reconnect of its own channel (server-side consumer sessions die
    with their connection)."""

    def __init__(
        self, broker: "NetBroker", conn: _Conn, topic: str, group: str | None,
        from_beginning: bool,
    ) -> None:
        self._broker = broker
        self._conn = conn
        self._lock = threading.RLock()
        self._cid = -1  # assigned by the first (re)open of the channel
        self._topic = topic
        self._group = group
        self._from_beginning = from_beginning
        self._last_positions: dict[int, int] | None = None
        self._closed = False
        from oryx_tpu_torch.common import ledger

        ledger.register("consumer", self, live=lambda c: not c.closed())

    def poll(self, max_records: int = 1000, timeout: float = 0.1) -> list[KeyMessage]:
        block = self.poll_block(max_records, timeout)
        if block is None:
            return []
        return list(block.iter_key_messages())

    def poll_block(self, max_records: int = 1000, timeout: float = 0.1):
        from oryx_tpu_torch.bus.blockcodec import lines_to_block
        from oryx_tpu_torch.common.records import RecordBlock

        resp, blob = self._broker._invoke(
            lambda: {"op": "poll", "cid": self._cid, "max_records": max_records, "timeout": timeout},
            consumer=self,
        )
        if "positions" in resp:
            # _invoke released the channel lock on return; retake it for
            # the cache write — the broker's reopen path reads
            # _last_positions to replay the seek (audit alongside the
            # baselined lockset ORX103 on _cid)
            with self._lock:
                self._last_positions = {
                    int(k): int(v) for k, v in resp["positions"].items()
                }
        if not blob:
            return None
        return lines_to_block(blob.split(b"\n")[:-1], RecordBlock)

    def positions(self) -> dict[int, int]:
        resp, _ = self._broker._invoke(
            lambda: {"op": "positions", "cid": self._cid}, consumer=self
        )
        pos = {int(k): int(v) for k, v in resp["positions"].items()}
        with self._lock:
            self._last_positions = dict(pos)
        return pos

    def seek(self, positions: dict[int, int]) -> None:
        self._broker._invoke(
            lambda: {
                "op": "seek",
                "cid": self._cid,
                "positions": {str(k): int(v) for k, v in positions.items()},
            },
            consumer=self,
        )
        with self._lock:
            merged = dict(self._last_positions or {})
            merged.update({int(k): int(v) for k, v in positions.items()})
            self._last_positions = merged

    def commit(self) -> None:
        self._broker._invoke(lambda: {"op": "commit", "cid": self._cid}, consumer=self)

    def close(self) -> None:
        with self._lock:  # check-then-set must be one atomic step
            if self._closed:
                return
            self._closed = True
            try:
                # best-effort, no reconnect dance just to close
                if self._conn.connected:
                    self._conn.call({"op": "consumer_close", "cid": self._cid})
            except (RuntimeError, ConnectionError, OSError):
                pass
            self._conn.close()

    def closed(self) -> bool:
        with self._lock:
            return self._closed


class NetBroker(Broker):
    """Broker SPI over a ``tcp://host:port`` bus server, with
    reconnect-with-backoff and a dedicated connection per consumer.

    Producers and admin ops share one channel (socket + lock); every
    consumer owns its own, so a consumer blocked in a server-side poll
    (up to the poll timeout) never stalls produces or other consumers on
    the same broker handle. Connections are opened lazily and re-opened
    on demand: any call that hits a connection error retries under
    `retry` (a RetryPolicy), and a successful reconnect of a consumer's
    channel reopens that consumer server-side and seeks it to its last
    known positions, so consumption resumes mid-stream across a
    bus-server restart. Produce retries are at-least-once (a request that
    died in flight may have landed)."""

    def __init__(
        self,
        host: str,
        port: int,
        connect_timeout: float = DEFAULT_CONNECT_TIMEOUT,
        retry: "RetryPolicy | None" = None,
    ) -> None:
        from oryx_tpu_torch.common.resilience import RetryPolicy

        self._host, self._port = host, port
        self._connect_timeout = connect_timeout
        self._conn = _Conn(host, port, connect_timeout)
        self._retry = retry or RetryPolicy(
            max_attempts=5, initial_backoff=0.1, max_backoff=5.0
        )
        self._io_lock = threading.RLock()

    @staticmethod
    def options_from_query(query: str) -> dict:
        """Constructor kwargs from tcp:// locator query params:
        connect_timeout (seconds), retry_max_attempts,
        retry_initial_backoff_ms, retry_max_backoff_ms."""
        from urllib.parse import parse_qsl

        from oryx_tpu_torch.common.resilience import RetryPolicy

        params = dict(parse_qsl(query, keep_blank_values=True))
        opts: dict = {}
        if "connect_timeout" in params:
            opts["connect_timeout"] = float(params["connect_timeout"])
        retry_kw: dict = {}
        if "retry_max_attempts" in params:
            retry_kw["max_attempts"] = int(params["retry_max_attempts"])
        if "retry_initial_backoff_ms" in params:
            retry_kw["initial_backoff"] = float(params["retry_initial_backoff_ms"]) / 1000.0
        if "retry_max_backoff_ms" in params:
            retry_kw["max_backoff"] = float(params["retry_max_backoff_ms"]) / 1000.0
        if retry_kw:
            opts["retry"] = RetryPolicy(**retry_kw)
        return opts

    def locator(self) -> str:
        return f"tcp://{self._host}:{self._port}"

    # -- connection management ----------------------------------------------

    def _open_consumer_session(self, c: _NetConsumer) -> None:
        """Caller holds the consumer's lock and its connection is up.
        (Re)open the server-side session on the consumer's own channel
        and seek it back to its last known positions."""
        resp, _ = c._conn.call(
            {
                "op": "consumer_open",
                "topic": c._topic,
                "group": c._group,
                "from_beginning": c._from_beginning,
            }
        )
        c._cid = int(resp["cid"])
        if c._last_positions:
            c._conn.call(
                {
                    "op": "seek",
                    "cid": c._cid,
                    "positions": {str(k): int(v) for k, v in c._last_positions.items()},
                }
            )

    def _invoke(self, header_fn, payload: bytes = b"", consumer: _NetConsumer | None = None):
        """Run one request, transparently (re)connecting with backoff.

        Routed over the consumer's dedicated channel when `consumer` is
        given (reconnects there also reopen that one server-side
        session), else over the shared producer/admin channel.
        `header_fn` is re-evaluated per attempt so consumer ops pick up
        the cid assigned by a reconnect's reopen; ``header_fn=None`` just
        ensures the channel is connected (used for the eager first open)."""
        conn = self._conn if consumer is None else consumer._conn
        lock = self._io_lock if consumer is None else consumer._lock
        failures = 0
        with lock:
            while True:
                try:
                    if not conn.connected:
                        conn.connect()
                        if consumer is not None:
                            self._open_consumer_session(consumer)
                        if failures:
                            metrics.registry.counter("bus.net.reconnects").inc()
                    if header_fn is None:
                        return None, b""
                    return conn.call(header_fn(), payload)
                except (ConnectionError, OSError) as e:
                    conn.drop()
                    if consumer is not None and consumer.closed():
                        raise
                    failures += 1
                    delay = self._retry.backoff_or_none(failures)
                    if delay is None:
                        metrics.registry.counter("bus.net.reconnect-failures").inc()
                        raise ConnectionError(
                            f"bus server {self._host}:{self._port} unreachable "
                            f"after {failures} attempts: {e}"
                        ) from e
                    log.warning(
                        "bus connection to %s:%d failed (%s); retry %d in %.2fs",
                        self._host, self._port, e, failures, delay,
                    )
                    time.sleep(delay)

    # -- Broker SPI ----------------------------------------------------------

    def create_topic(self, topic: str, partitions: int = 1, config: dict | None = None) -> None:
        self._invoke(
            lambda: {"op": "create_topic", "topic": topic, "partitions": partitions, "config": config}
        )

    def topic_exists(self, topic: str) -> bool:
        resp, _ = self._invoke(lambda: {"op": "topic_exists", "topic": topic})
        return bool(resp["exists"])

    def delete_topic(self, topic: str) -> None:
        self._invoke(lambda: {"op": "delete_topic", "topic": topic})

    def producer(self, topic: str) -> TopicProducer:
        return _NetProducer(self, topic)

    def consumer(
        self, topic: str, group: str | None = None, from_beginning: bool = False,
        partitions: list[int] | None = None,
    ) -> TopicConsumer:
        if partitions is not None:
            raise ValueError(
                "tcp:// consumers do not support manual partition assignment"
            )
        c = _NetConsumer(
            self,
            _Conn(self._host, self._port, self._connect_timeout),
            topic, group, from_beginning,
        )
        # open the dedicated channel + server session eagerly so a bad
        # topic/server fails here (with retry/backoff), not at first poll
        self._invoke(None, consumer=c)
        return c

    def get_offsets(self, group: str, topic: str) -> dict[int, int]:
        resp, _ = self._invoke(lambda: {"op": "get_offsets", "group": group, "topic": topic})
        return {int(k): int(v) for k, v in resp["offsets"].items()}

    def set_offsets(self, group: str, topic: str, offsets: dict[int, int]) -> None:
        self._invoke(
            lambda: {"op": "set_offsets", "group": group, "topic": topic,
                     "offsets": {str(k): int(v) for k, v in offsets.items()}}
        )

    def latest_offsets(self, topic: str) -> dict[int, int]:
        resp, _ = self._invoke(lambda: {"op": "latest_offsets", "topic": topic})
        return {int(k): int(v) for k, v in resp["offsets"].items()}
