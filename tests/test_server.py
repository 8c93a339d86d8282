"""Persistent codec server round trip: a real
subprocess server on a unix socket, driven through the forwarding client
path the CLI uses."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.conftest import make_test_image


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("srv") / "jxl.sock")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JXL_JAX_SOCKET=sock)
    env.pop("JXL_JAX_NO_SERVER", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "jxl_jax", "serve"],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    deadline = time.time() + 120
    while time.time() < deadline and not os.path.exists(sock):
        if proc.poll() is not None:
            pytest.fail("server exited early")
        time.sleep(0.5)
    assert os.path.exists(sock), "server socket never appeared"
    yield sock
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(sock)
        f = c.makefile("rwb")
        f.write((json.dumps({"cmd": "shutdown"}) + "\n").encode())
        f.flush()
        f.readline()
    except OSError:
        proc.kill()
    proc.wait(timeout=30)


def test_server_ping(server):
    from jxl_jax.cli.server import try_forward

    rep = try_forward({"cmd": "ping"}, socket_path=server)
    assert rep == {"ok": True, "msg": "pong"}


def test_server_encode_decode_roundtrip(server, tmp_path):
    from jxl_jax.cli.server import try_forward
    from jxl_jax.core.io import write_image

    img = make_test_image(48, 64, seed=21)
    src = str(tmp_path / "in.png")
    jxt = str(tmp_path / "out.jxt")
    back = str(tmp_path / "back.png")
    write_image(src, img)

    rep = try_forward(
        {"cmd": "encode", "input": src, "output": jxt, "distance": 2.0,
         "effort": 3},
        socket_path=server,
    )
    assert rep and rep["ok"], rep
    assert os.path.getsize(jxt) > 0

    rep = try_forward(
        {"cmd": "decode", "input": jxt, "output": back}, socket_path=server
    )
    assert rep and rep["ok"], rep
    from jxl_jax.core.io import read_image

    out = read_image(back)
    mse = np.mean((out.astype(np.float64) - img.astype(np.float64)) ** 2)
    assert 10 * np.log10(255.0**2 / mse) > 28.0


def test_server_error_is_clean(server):
    from jxl_jax.cli.server import try_forward

    rep = try_forward(
        {"cmd": "decode", "input": "/nonexistent.jxt", "output": "/tmp/x.png"},
        socket_path=server,
    )
    assert rep is not None and not rep["ok"]
    assert "error" in rep


def test_no_server_returns_none(tmp_path):
    from jxl_jax.cli.server import try_forward

    assert try_forward({"cmd": "ping"}, socket_path=str(tmp_path / "no.sock")) is None
    os.environ["JXL_JAX_NO_SERVER"] = "1"
    try:
        assert try_forward({"cmd": "ping"}, socket_path="/tmp") is None
    finally:
        del os.environ["JXL_JAX_NO_SERVER"]


def test_server_survives_client_disconnect(server):
    """A client that connects and vanishes (or stays silent) must not
    kill or wedge the accept loop."""
    from jxl_jax.cli.server import try_forward

    # connect and drop immediately (write nothing)
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(server)
    c.close()
    # connect, send garbage without newline, drop
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(server)
    c.sendall(b'{"cmd": "enc')
    c.close()
    rep = try_forward({"cmd": "ping"}, socket_path=server)
    assert rep == {"ok": True, "msg": "pong"}


def test_codec_env_knobs_disable_forwarding(server, monkeypatch, tmp_path):
    """A client steering the codec via JXL_JAX_* env must not be forwarded
    (the server's environment would otherwise govern the encode); beside a
    live server it must not run locally either (a second process on the
    device), so it stops with ServerBusy. With no server it runs locally."""
    from jxl_jax.cli.server import ServerBusy, try_forward

    monkeypatch.setenv("JXL_JAX_MODULAR", "0")
    with pytest.raises(ServerBusy, match="JXL_JAX_MODULAR"):
        try_forward({"cmd": "ping"}, socket_path=server)
    assert try_forward({"cmd": "ping"}, socket_path=str(tmp_path / "no.sock")) is None
    monkeypatch.delenv("JXL_JAX_MODULAR")
    monkeypatch.setenv("JXL_JAX_NO_CACHE", "1")  # non-codec knob: forwards
    assert try_forward({"cmd": "ping"}, socket_path=server)["ok"]


def test_cli_refuses_local_run_beside_live_server(server, monkeypatch, tmp_path, capsys):
    """`python -m jxl_jax encode` with JXL_JAX_NO_SERVER=1 beside a live
    server exits non-zero with the reason, before touching the input."""
    from jxl_jax.cli.main import main

    monkeypatch.setenv("JXL_JAX_NO_SERVER", "1")
    monkeypatch.setattr("jxl_jax.cli.server.DEFAULT_SOCKET", server)
    rc = main(["encode", str(tmp_path / "missing.png"), str(tmp_path / "o.jxt")])
    assert rc == 2
    assert "holds the device" in capsys.readouterr().err


def test_default_socket_is_in_the_temp_dir():
    import tempfile

    from jxl_jax.cli import server as srv

    if "JXL_JAX_SOCKET" not in os.environ:
        assert srv.DEFAULT_SOCKET == os.path.join(tempfile.gettempdir(), "jxl_jax.sock")


@pytest.mark.parametrize("name", ["JXL_OLD_MODULAR", "JXL_NO_SERVER", "JXL_JAXX"])
def test_foreign_jxl_knob_is_refused(monkeypatch, name):
    """A JXL_* variable outside the JXL_JAX_* family would be ignored
    silently, so importing the package refuses it."""
    import jxl_jax

    monkeypatch.setenv(name, "1")
    with pytest.raises(RuntimeError, match=name):
        jxl_jax._refuse_foreign_knobs()


def test_own_knobs_are_accepted(monkeypatch):
    import jxl_jax

    monkeypatch.setenv("JXL_JAX_MODULAR", "0")
    jxl_jax._refuse_foreign_knobs()


def test_foreign_knob_stops_the_cli_before_any_work(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", JXL_OLD_NO_SERVER="1")
    r = subprocess.run(
        [sys.executable, "-m", "jxl_jax", "decode", str(tmp_path / "x.jxt"), str(tmp_path / "y.png")],
        env=env, capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode != 0
    assert "JXL_OLD_NO_SERVER" in r.stderr and "JXL_JAX_" in r.stderr
