"""AdminSocket: per-daemon unix-socket command framework (the
src/common/admin_socket.h:106 role).

Commands register as (name, callback) where callback(args: dict) ->
json-able object; the wire is one JSON request line in, one JSON reply
out per connection (`ceph daemon <sock> <command>` usage). Built-ins
mirror the reference: "help", plus whatever the daemon registers
("perf dump", "config show", "config set", "log dump", ...).

ceph_tpu_torch's own copy of ``ceph_tpu/utils/admin.py``.
"""
from __future__ import annotations

import asyncio
import json
import os
from typing import Any, Callable

Handler = Callable[[dict], Any]


class AdminSocket:
    def __init__(self, path: str):
        self.path = path
        self._handlers: dict[str, tuple[Handler, str]] = {}
        self._server: asyncio.AbstractServer | None = None
        self.register("help", self._help, "list registered commands")

    # ------------------------------------------------------ registration

    def register(self, command: str, handler: Handler,
                 desc: str = "") -> None:
        if command in self._handlers:
            raise KeyError(f"admin command {command!r} already registered")
        self._handlers[command] = (handler, desc)

    def unregister(self, command: str) -> None:
        self._handlers.pop(command, None)

    def _help(self, args: dict) -> dict:
        return {cmd: desc for cmd, (_, desc) in sorted(
            self._handlers.items()
        )}

    # ------------------------------------------------------------ serve

    async def start(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._server = await asyncio.start_unix_server(
            self._handle, path=self.path
        )

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if os.path.exists(self.path):
            os.unlink(self.path)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            try:
                req = json.loads(line) if line.strip() else {}
            except json.JSONDecodeError:
                req = {"prefix": line.decode(errors="replace").strip()}
            prefix = req.get("prefix", "help")
            entry = self._handlers.get(prefix)
            if entry is None:
                reply = {"error": f"unknown command {prefix!r}",
                         "known": sorted(self._handlers)}
            else:
                handler, _ = entry
                try:
                    result = handler(
                        {k: v for k, v in req.items() if k != "prefix"}
                    )
                    if asyncio.iscoroutine(result):
                        result = await result
                    reply = {"ok": True, "result": result}
                except Exception as e:  # surfaced to the caller, not fatal
                    reply = {"error": f"{type(e).__name__}: {e}"}
            writer.write(json.dumps(reply).encode() + b"\n")
            await writer.drain()
        finally:
            writer.close()


async def admin_command(path: str, prefix: str, **args) -> Any:
    """Client side (`ceph daemon` role): send one command, return the
    parsed result; raises RuntimeError on error replies."""
    reader, writer = await asyncio.open_unix_connection(path)
    req = {"prefix": prefix, **args}
    writer.write(json.dumps(req).encode() + b"\n")
    await writer.drain()
    raw = await reader.readline()
    writer.close()
    reply = json.loads(raw)
    if "error" in reply:
        raise RuntimeError(reply["error"])
    return reply["result"]
