"""RemoteBackend: actors hosted in external processes over socket RPC
(PyTorch port of ``repro/core/remote.py``).

The thread and process backends both live on the driver's box.  This module
crosses the host boundary, towards MSRL/SRL-scale topologies: a ``RemoteHost`` server
process (potentially on another machine) builds and owns actor targets, and
a ``RemoteCell`` on the driver speaks to it over a length-prefixed socket
RPC protocol (``core.transport.encode_frame``/``FrameDecoder``).

The protocol deliberately reuses the shapes the in-box runtime already has:

  * **Handshake with name-generation** — the first frame on a connection is
    ``("hello", name, prefix, factory_bytes, transport_bytes)``.  ``prefix``
    follows the ``ProcessCell`` scheme (``rmt<pid>x<cell>g<generation>``):
    a fresh generation per (re)connect, so a restarted cell gets a fresh
    target and its transport endpoints can never collide with a prior life.
    The host replies ``(True, {"pid": ..., "name": ...})`` once the target
    is constructed, or ``(False, exc)`` carrying the real construction
    error.
  * **RPC frames** — ``(method, args, kwargs, released)``: byte-identical
    in shape to the ``ProcessCell`` pipe message, so everything above the
    cell (``_Proxy``/``apply``, supervision, gather operators) is reused
    verbatim.  Replies are ``(ok, payload)`` with payload run through the
    cell's transport endpoints (``SocketTransport`` by default: batch
    columns as one contiguous blob per batch).
  * **Heartbeat** — an idle cell pings ``("__ping__", (), {}, [])`` on a
    background thread; the host answers without touching the target.  A
    failed ping marks the cell dead, so a lost machine surfaces as
    ``ActorDiedError`` (a *shard loss* to the failure policies) even when
    the flow is between calls.

A whole host dying takes every cell homed on it down at once — that is the
"machine loss" failure mode the chaos suites inject, and
``FailurePolicy.DROP_SHARD`` shrinks the shard set exactly as it does for a
killed worker process.

Every frame is pickled with ``core.transport.dumps``: a torch tensor in an
RPC's arguments or result crosses as host bytes and is rebuilt on the device
it left.  The targets homed on one host share that host process's CUDA
context.
"""

from __future__ import annotations

import itertools
import logging
import os
import socket
import threading
import time
from typing import Any, Callable, Optional, Tuple

from repro_torch.core.executor import (
    ActorDiedError,
    ActorError,
    BACKENDS,
    Cell,
    ExecutionBackend,
    _Proxy,
    _ReturnTarget,
    mp_context,
)
from repro_torch.core.transport import (
    FrameDecoder,
    SocketTransport,
    Transport,
    dumps,
    encode_frame,
    loads,
    resolve_transport,
)

__all__ = [
    "RemoteBackend",
    "RemoteCell",
    "LocalHostHandle",
    "start_local_host",
    "PING_METHOD",
]

_logger = logging.getLogger(__name__)

_cell_seq = itertools.count()

PING_METHOD = "__ping__"  # heartbeat: served host-side, never hits the target

_RECV_CHUNK = 1 << 16


def _resolve_remote_transport(transport: Any) -> Transport:
    """Default to the socket data plane: shm's ``resolve_transport(None)``
    default is an intra-host assumption this backend exists to break."""
    if transport is None:
        return SocketTransport()
    return resolve_transport(transport)


# --------------------------------------------------------------------------
# Host side: the server process that owns actor targets
# --------------------------------------------------------------------------
def _serve_remote_connection(conn: socket.socket, peer: Any) -> None:
    """Serve one actor cell over one connection (mirrors executor._serve).

    The first frame must be the hello handshake; after that the loop is the
    ``ProcessCell`` serve loop with the pipe swapped for framed sockets:
    reclaim released refs, dispatch the method, encode the result through
    the negotiated transport, reply ``(ok, payload)``.
    """
    decoder = FrameDecoder()
    target: Any = None
    encoder: Any = None

    def _send(obj: Any) -> None:
        conn.sendall(encode_frame(obj))

    def _frames():
        while True:
            try:
                chunk = conn.recv(_RECV_CHUNK)
            except OSError:
                return
            if not chunk:
                return
            for msg in decoder.feed(chunk):
                yield msg

    frames = _frames()
    try:
        try:
            hello = next(frames)
        except StopIteration:
            return
        try:
            kind, name, prefix, factory_bytes, transport_bytes = hello
            if kind != "hello":
                raise ActorError(f"expected hello handshake, got {kind!r}")
            spec = loads(transport_bytes)
            encoder = spec.server_endpoint(prefix)
            target = loads(factory_bytes)()
        except BaseException as exc:
            try:
                _send((False, exc))
            except Exception:
                _send((False, ActorError(f"target construction failed: {exc!r}")))
            return
        _send((True, {"pid": os.getpid(), "name": name}))
        for msg in frames:
            if msg is None:  # graceful cell shutdown
                return
            method, args, kwargs, released = msg
            encoder.reclaim(released)
            if method == PING_METHOD:
                _send((True, "pong"))
                continue
            try:
                result = getattr(target, method)(*args, **kwargs)
            except BaseException as exc:
                try:
                    _send((False, exc))
                except Exception:  # unpicklable exception: degrade to a summary
                    _send((False, ActorError(f"{type(exc).__name__}: {exc}")))
                continue
            try:
                wire = encoder.encode(result)
                _send((True, wire))
            except Exception as exc:
                try:
                    _send((False, ActorError(f"transport encode failed for {method}(): {exc!r}")))
                except OSError:
                    return
    except OSError:
        pass  # peer vanished mid-reply: the cell will report ActorDiedError
    finally:
        if encoder is not None:
            encoder.close()
        stop = getattr(target, "stop", None)
        if callable(stop):
            try:
                stop()
            except Exception:
                pass
        try:
            conn.close()
        except OSError:
            pass


def _host_main(port: int, ready: Any) -> None:
    """RemoteHost entry point: accept loop, one serving thread per cell.

    Run in its own (spawned) process: a fresh interpreter, so targets that
    use CUDA initialise it cleanly whatever the driver has done.
    Reports the bound ``(host, port)`` through ``ready`` — ``port=0`` lets
    the OS pick, which is what the localhost test matrix uses.
    """
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("127.0.0.1", port))
    server.listen()
    ready.send(server.getsockname())
    ready.close()
    while True:
        try:
            conn, peer = server.accept()
        except OSError:
            return
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        threading.Thread(
            target=_serve_remote_connection,
            args=(conn, peer),
            daemon=True,
            name="remote-cell-serve",
        ).start()


class LocalHostHandle:
    """A RemoteHost process this driver launched (and may kill).

    ``kill()`` is the machine-loss injector's lever: terminating the process
    drops every fragment endpoint homed on it at once.
    """

    def __init__(self, proc: Any, address: Tuple[str, int]):
        self._proc = proc
        self.address = address

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    @property
    def pid(self) -> Optional[int]:
        """OS pid of the host process (None once reaped)."""
        return getattr(self._proc, "pid", None)

    def kill(self) -> None:
        """Terminate the host process (abrupt: simulated machine loss)."""
        if self._proc is None:
            return
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5.0)

    def stop(self) -> None:
        self.kill()

    def __repr__(self) -> str:  # pragma: no cover
        return f"LocalHostHandle({self.address!r}, alive={self.alive})"


def start_local_host(port: int = 0, start_method: str = "spawn") -> LocalHostHandle:
    """Launch a RemoteHost on localhost; returns once its port is bound.

    Spawn (never fork) so the host interpreter is clean: its targets will
    likely use CUDA, and a child forked from a driver that has initialised
    CUDA cannot (``"forkserver"`` is accepted too, ``"fork"`` raises).
    """
    ctx = mp_context(start_method)
    parent, child = ctx.Pipe()
    proc = ctx.Process(
        target=_host_main, args=(port, child), daemon=True, name="remote-host"
    )
    proc.start()
    child.close()
    if not parent.poll(30.0):
        proc.terminate()
        raise ActorError("remote host failed to bind within 30s")
    address = tuple(parent.recv())
    parent.close()
    return LocalHostHandle(proc, address)  # type: ignore[arg-type]


# --------------------------------------------------------------------------
# Driver side: the cell + backend
# --------------------------------------------------------------------------
class RemoteCell(Cell):
    """Target lives on a RemoteHost; calls are framed socket RPCs.

    Like ``ProcessCell`` the factory is pickled eagerly (a cell that
    constructs at all can always be restarted) and each (re)connect bumps
    the name generation, so the host builds a fresh target whose transport
    prefix can never collide with a previous life's.
    """

    def __init__(
        self,
        factory: Optional[Callable[[], Any]] = None,
        target: Any = None,
        address: Tuple[str, int] = ("127.0.0.1", 0),
        transport: Any = None,
        connect_timeout: float = 10.0,
        heartbeat_interval: Optional[float] = 5.0,
    ):
        payload = factory if factory is not None else _ReturnTarget(target)
        self._payload = dumps(payload)
        self._transport = _resolve_remote_transport(transport)
        self._address = (str(address[0]), int(address[1]))
        self._connect_timeout = connect_timeout
        self._heartbeat_interval = heartbeat_interval
        self._prefix_base = f"rmt{os.getpid()}x{next(_cell_seq)}"
        self._generation = 0
        self._sock: Optional[socket.socket] = None
        self._frames: Optional[FrameDecoder] = None
        self._decoder: Any = None
        self._dead = False
        self._stopped = False
        self._lock = threading.Lock()  # serializes request/reply pairs
        self._last_rpc = time.monotonic()
        self._proxy = _Proxy(self)  # RemoteCell.rpc matches the _Proxy contract
        # Framed bytes each way, as ``ProcessCell.wire_bytes`` counts them.
        self.wire_bytes = {"sent": 0, "received": 0}
        self._connect()
        if heartbeat_interval is not None:
            self._hb_stop = threading.Event()
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True, name="remote-cell-heartbeat"
            )
            self._hb_thread.start()
        else:
            self._hb_stop = None  # type: ignore[assignment]
            self._hb_thread = None  # type: ignore[assignment]

    # ----------------------------------------------------------- connection
    def _connect(self) -> None:
        self._generation += 1
        prefix = f"{self._prefix_base}g{self._generation}"
        try:
            sock = socket.create_connection(self._address, timeout=self._connect_timeout)
        except OSError as exc:
            self._dead = True
            raise ActorDiedError(
                f"remote host {self._address} unreachable: {exc}"
            ) from exc
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)  # RPCs block like ProcessCell pipe recv
        self._sock = sock
        self._frames = FrameDecoder()
        self._decoder = self._transport.client_endpoint(prefix)
        hello = ("hello", prefix, prefix, self._payload, dumps(self._transport))
        try:
            sock.sendall(encode_frame(hello))
            sock.settimeout(self._connect_timeout)
            ok, info = self._recv_reply("__handshake__")
            sock.settimeout(None)
        except ActorDiedError:
            self._dead = True
            raise
        if not ok:
            self._dead = True
            self._close_socket()
            err = info if isinstance(info, BaseException) else ActorError(repr(info))
            raise ActorError(f"remote target construction failed: {err!r}") from (
                err if isinstance(err, BaseException) else None
            )
        self._dead = False

    def _close_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None

    def _recv_reply(self, method: str) -> Tuple[bool, Any]:
        # Local refs: kill()/stop() may null out self._sock from another
        # thread to unblock this recv (the close makes it raise OSError).
        sock, frames = self._sock, self._frames
        assert sock is not None and frames is not None
        while True:
            try:
                chunk = sock.recv(_RECV_CHUNK)
            except OSError as exc:
                raise self._death_error(method, exc) from None
            if not chunk:
                raise self._death_error(method, None) from None
            self.wire_bytes["received"] += len(chunk)
            msgs = frames.feed(chunk)
            if msgs:
                # Strict request/reply: at most one reply can be in flight.
                return msgs[0]

    def _death_error(self, method: str, cause: Any) -> ActorDiedError:
        self._dead = True
        self._close_socket()
        detail = f": {cause}" if cause else ""
        return ActorDiedError(
            f"remote cell on {self._address} died during {method}() "
            f"(generation={self._generation}){detail}"
        )

    # ------------------------------------------------------------------ rpc
    def rpc(self, method: str, args: tuple, kwargs: dict) -> Any:
        with self._lock:
            sock = self._sock
            if self._dead or sock is None:
                raise ActorDiedError(
                    f"remote cell on {self._address} is dead "
                    f"(generation={self._generation}); cannot run {method}()"
                )
            frame = encode_frame((method, args, kwargs, self._decoder.drain_releases()))
            try:
                sock.sendall(frame)
            except OSError as exc:
                raise self._death_error(method, exc) from None
            self.wire_bytes["sent"] += len(frame)
            ok, payload = self._recv_reply(method)
            self._last_rpc = time.monotonic()
        if ok:
            return self._decoder.decode(payload)
        raise payload

    # ------------------------------------------------------------ heartbeat
    def _heartbeat_loop(self) -> None:
        interval = self._heartbeat_interval
        assert interval is not None
        while not self._hb_stop.wait(interval):
            if self._dead or self._stopped:
                return
            if time.monotonic() - self._last_rpc < interval:
                continue  # real traffic is the best heartbeat
            try:
                self.rpc(PING_METHOD, (), {})
            except BaseException as exc:
                if not self._stopped:
                    _logger.warning(
                        "remote cell %s heartbeat failed: %r", self._address, exc
                    )
                return  # rpc() already marked the cell dead

    # ------------------------------------------------------------ lifecycle
    @property
    def target(self) -> Any:
        return self._proxy

    @property
    def alive(self) -> bool:
        return not self._dead and self._sock is not None

    def restart(self) -> None:
        """Reconnect with a bumped generation: the host builds a fresh
        target (the old connection's serving thread tears the old one
        down when its socket dies)."""
        with self._lock:
            self._close_socket()
            self._connect()
            self._last_rpc = time.monotonic()

    def stop(self) -> None:
        """Graceful: frame ``None`` so the host tears the target down, then
        close.  Never blocks on a wedged RPC — if the lock can't be had
        quickly, degrade to ``kill()`` (the close unblocks the RPC)."""
        self._stopped = True
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._lock.acquire(timeout=1.0):
            try:
                if self._sock is not None:
                    try:
                        self._sock.sendall(encode_frame(None))
                    except OSError:
                        pass
            finally:
                self._lock.release()
        self.kill()

    def kill(self) -> None:
        # Deliberately lock-free: closing the socket is what unblocks an
        # in-flight recv (it raises OSError into _recv_reply, which marks
        # the cell dead on that thread).
        self._stopped = True
        self._dead = True
        if self._hb_stop is not None:
            self._hb_stop.set()
        self._close_socket()
        if self._decoder is not None:
            self._decoder.close()


class RemoteBackend(ExecutionBackend):
    """Cells homed on one RemoteHost address (one backend per host)."""

    name = "remote"

    def __init__(
        self,
        address: Any = None,
        transport: Any = None,
        heartbeat_interval: Optional[float] = 5.0,
        connect_timeout: float = 10.0,
    ):
        if address is None:
            raise ValueError(
                'RemoteBackend needs a host address: RemoteBackend(("10.0.0.2", 7011)) '
                'or RemoteBackend("10.0.0.2:7011")'
            )
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(f"address string must be 'host:port' (got {address!r})")
            address = (host, int(port))
        self.address: Tuple[str, int] = (str(address[0]), int(address[1]))
        self.transport = _resolve_remote_transport(transport)
        self.heartbeat_interval = heartbeat_interval
        self.connect_timeout = connect_timeout

    def make_cell(
        self, factory: Optional[Callable[[], Any]] = None, target: Any = None
    ) -> Cell:
        return RemoteCell(
            factory=factory,
            target=target,
            address=self.address,
            transport=self.transport,
            connect_timeout=self.connect_timeout,
            heartbeat_interval=self.heartbeat_interval,
        )


# Registered for discoverability/error messages; RemoteBackend requires an
# address, so string resolution ("remote") fails loudly with the hint above
# instead of silently building a cell with nowhere to connect.
BACKENDS.setdefault("remote", RemoteBackend)
