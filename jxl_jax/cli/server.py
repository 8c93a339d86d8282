"""Persistent codec server: one process holds the device for many calls.

A fresh Python process pays JAX start-up and program loads before any
pixels move, while the reference's `cjxl`/`djxl` equivalents are cheap
subprocesses whose harness semantics assume per-invocation execution is
cheap (`docker_manager.rs:100-136`). The server keeps ONE process (and its
compiled programs and fetch-window history) alive behind a unix socket;
later `python -m jxl_jax encode/decode` invocations auto-forward when the
socket exists, paying only a light client process + the codec work.

It is also the one process on the device: a JAX process reserves most of
a GPU's memory when it starts, so a second process beside a live server
would fail for want of memory. A client whose request may not be
forwarded (codec knobs set, or JXL_JAX_NO_SERVER=1) therefore stops with
an error while a server answers, instead of opening the device itself.

  python -m jxl_jax serve [--socket PATH] &   # default $TMPDIR/jxl_jax.sock
  python -m jxl_jax encode in.png out.jxt --distance 1.0   # forwarded
  JXL_JAX_NO_SERVER=1 python -m jxl_jax encode ...          # local, no server

Protocol: one JSON request line per connection
  {"cmd": "encode"|"decode"|"ping"|"shutdown", ...}
reply: {"ok": true, "msg": "..."} | {"ok": false, "error": "..."}.
Paths are resolved server-side — client and server share a filesystem.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile

DEFAULT_SOCKET = os.environ.get(
    "JXL_JAX_SOCKET", os.path.join(tempfile.gettempdir(), "jxl_jax.sock")
)

# JXL_JAX_* variables that do not steer the codec: a request made with
# only these set may be forwarded
_NON_CODEC = {"JXL_JAX_NO_SERVER", "JXL_JAX_SOCKET", "JXL_JAX_NO_CACHE"}


class ServerBusy(RuntimeError):
    """A live server holds the device, but this request may not go to it."""


def _handle(req: dict) -> dict:
    cmd = req.get("cmd")
    if cmd == "ping":
        return {"ok": True, "msg": "pong"}
    if cmd == "encode":
        import time

        from jxl_jax.codec.config import CodecConfig, Strategy
        from jxl_jax.core.io import read_image

        cfg = CodecConfig(
            distance=float(req.get("distance", 1.0)),
            effort=int(req.get("effort", 7)),
            strategy=Strategy[req.get("strategy", "BASELINE")],
            lanes=int(req.get("lanes", 256)),
        )
        rgb = read_image(req["input"])
        t0 = time.perf_counter()
        if int(req.get("stripes", 0)):
            from jxl_jax.codec.tiled import encode_image_striped

            data = encode_image_striped(
                rgb, cfg, n_stripes=int(req["stripes"]),
                orig_name=os.path.basename(req["input"]),
            )
            with open(req["output"], "wb") as f:
                f.write(data)
            size = len(data)
        else:
            from jxl_jax.codec.encode import encode_file

            size = encode_file(req["input"], req["output"], cfg)
        dt = time.perf_counter() - t0
        h, w = rgb.shape[:2]
        return {
            "ok": True,
            "msg": f"{req['output']}: {size} bytes, {size * 8 / (h * w):.3f} "
            f"bpp, {h * w / 1e6 / dt:.2f} MP/s",
        }
    if cmd == "decode":
        import time

        from jxl_jax.codec.decode import decode_file
        from jxl_jax.core.io import write_image

        t0 = time.perf_counter()
        px = decode_file(req["input"])
        dt = time.perf_counter() - t0
        write_image(req["output"], px)
        h, w = px.shape[:2]
        return {
            "ok": True,
            "msg": f"{req['output']}: {w}x{h}, {h * w / 1e6 / dt:.2f} MP/s",
        }
    if cmd == "shutdown":
        return {"ok": True, "msg": "bye", "_shutdown": True}
    return {"ok": False, "error": f"unknown cmd {cmd!r}"}


def serve(socket_path: str = DEFAULT_SOCKET, warm: bool = True) -> int:
    # warm the backend (device start-up + a tiny program) before accepting
    if warm:
        import jax
        import jax.numpy as jnp

        jnp.add(jnp.ones(()), 1.0).block_until_ready()
        plat = jax.devices()[0].platform
    else:
        plat = "lazy"
    try:
        os.unlink(socket_path)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(socket_path)
    srv.listen(4)
    print(f"[serve] ready on {socket_path} (backend: {plat})", flush=True)
    try:
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    # a silent client must not wedge the single-threaded
                    # accept loop; codec work itself runs with no deadline
                    conn.settimeout(10.0)
                    f = conn.makefile("rwb")
                    line = f.readline()
                    if not line:
                        continue
                    conn.settimeout(None)
                    try:
                        req = json.loads(line)
                        rep = _handle(req)
                    except Exception as e:  # clean error back to the client
                        rep = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    f.write((json.dumps(rep) + "\n").encode())
                    f.flush()
                    if rep.get("_shutdown"):
                        return 0
                except OSError:
                    # client vanished mid-request (Ctrl-C, kill, timeout):
                    # drop the connection, keep serving
                    continue
    finally:
        srv.close()
        try:
            os.unlink(socket_path)
        except FileNotFoundError:
            pass


def _request(req: dict, socket_path: str):
    """One request/reply over the socket; None when no server answers."""
    if not os.path.exists(socket_path):
        return None
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.settimeout(5.0)
        c.connect(socket_path)
        c.settimeout(3600.0)  # codec work can legitimately take a while
        f = c.makefile("rwb")
        f.write((json.dumps(req) + "\n").encode())
        f.flush()
        line = f.readline()
        c.close()
        if not line:
            return None
        return json.loads(line)
    except (OSError, json.JSONDecodeError):
        return None


def try_forward(req: dict, socket_path: str | None = None):
    """Forward a request to a running server; returns the reply dict, or
    None when no server answers (the caller then runs locally). Client
    side starts no JAX backend — the point is skipping device start-up.

    A request may not be forwarded when JXL_JAX_NO_SERVER is set or when
    a codec knob (any other JXL_JAX_* variable) is set client-side: the
    SERVER's environment would silently govern it. If a server answers
    ping all the same, raises ServerBusy: running locally would open a
    second process on the device the server holds."""
    socket_path = socket_path or DEFAULT_SOCKET
    knobs = sorted(
        k for k in os.environ if k.startswith("JXL_JAX_") and k not in _NON_CODEC
    )
    if os.environ.get("JXL_JAX_NO_SERVER") or knobs:
        if _request({"cmd": "ping"}, socket_path) is not None:
            why = ", ".join(knobs) if knobs else "JXL_JAX_NO_SERVER"
            raise ServerBusy(
                f"a jxl_jax server on {socket_path} holds the device, and this "
                f"request may not be forwarded to it ({why} set); stop the "
                "server or unset the variable"
            )
        return None
    return _request(req, socket_path)
