"""A peer dropped while the port's transport writes to it (ROADMAP C9).

Both read loops of ``distriflow_tpu_torch/comm/transport.py`` catch
``ConnectionError``: a client that goes away while the server echoes its
heartbeats surfaces as ``BrokenPipeError`` (the write after the peer's
reset of a half-closed connection), not only ``ConnectionResetError``.
Nothing may reach the event loop's exception handler, the server goes on
serving the next client, and a client whose server breaks the pipe calls
``on_server_lost``. JAX's transport catches the reset alone; the port
diverges on purpose (ROADMAP's reference behaviours)."""

import select
import socket
import threading
import time

import pytest

from distriflow_tpu_torch.comm import transport
from distriflow_tpu_torch.comm.codec import encode
from distriflow_tpu_torch.obs import Telemetry

pytestmark = pytest.mark.port


def _wait(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            return False
        time.sleep(0.005)
    return True


@pytest.fixture()
def server():
    srv = transport.ServerTransport(heartbeat_timeout=0, telemetry=Telemetry()).start()
    srv.on("ping", lambda cid, payload: payload)
    errors = []
    srv._loop.call_soon_threadsafe(
        srv._loop.set_exception_handler, lambda loop, ctx: errors.append(ctx))
    try:
        yield srv, errors
    finally:
        srv.stop()


def _drop_mid_echo(srv, frames):
    """Send ``frames`` heartbeats in one write, half-close, and close with
    the server's echoes unread once the first one arrived: the close
    resets a connection the server still writes to. Whether the server
    sees that as a reset or as a broken pipe depends on timing, so the two
    tests after this one hold each read loop's catch deterministically."""
    sock = socket.create_connection((srv.host, srv.port))
    sock.sendall(transport.frame_bytes(encode({"event": transport._HB_EVENT})) * frames)
    sock.shutdown(socket.SHUT_WR)
    select.select([sock], [], [], 10.0)
    sock.close()


@pytest.mark.parametrize("frames", [2000, 20000])
def test_client_dropped_mid_write_reaches_no_handler(server, frames):
    srv, errors = server
    for _ in range(5):
        _drop_mid_echo(srv, frames)
        assert _wait(lambda: srv.num_clients == 0), "the dropped client was never reaped"
    assert errors == [], [str(e.get("exception") or e.get("message")) for e in errors]
    client = transport.ClientTransport(srv.address, heartbeat_interval=0).connect()
    try:
        assert client.request("ping", {"n": 7}, timeout=10.0) == {"n": 7}
    finally:
        client.close()


def test_server_read_loop_takes_a_broken_pipe(server, monkeypatch):
    """The server loop's read fails with BrokenPipeError (what a write
    after the peer's reset leaves in the stream): the connection closes
    quietly and the next client is served."""
    srv, errors = server
    real = transport._read_frame
    calls = []

    async def broken_once(reader):
        if not calls:
            calls.append(1)
            raise BrokenPipeError(32, "Broken pipe")
        return await real(reader)

    monkeypatch.setattr(transport, "_read_frame", broken_once)
    sock = socket.create_connection((srv.host, srv.port))
    assert _wait(lambda: calls) and _wait(lambda: srv.num_clients == 0)
    sock.close()
    assert errors == []
    client = transport.ClientTransport(srv.address, heartbeat_interval=0).connect()
    try:
        assert client.request("ping", 1, timeout=10.0) == 1
    finally:
        client.close()


def test_client_read_loop_takes_a_broken_pipe(monkeypatch):
    """The client loop's read fails with BrokenPipeError: ``on_server_lost``
    runs (the reconnect path) and nothing escapes the loop's thread."""
    listener = socket.create_server(("127.0.0.1", 0))
    escaped = []
    monkeypatch.setattr(threading, "excepthook", lambda args: escaped.append(args))

    async def broken(reader):
        raise BrokenPipeError(32, "Broken pipe")

    monkeypatch.setattr(transport, "_read_frame", broken)
    lost = threading.Event()
    client = transport.ClientTransport(f"127.0.0.1:{listener.getsockname()[1]}",
                                       heartbeat_interval=0)
    client.on_server_lost = lost.set
    try:
        client.connect()
        conn, _ = listener.accept()
        assert lost.wait(10.0), "on_server_lost never ran"
        client._thread.join(10.0)
        assert escaped == []
        conn.close()
    finally:
        client.close()
        listener.close()
