"""MgrModule: the mgr's loadable-module API (the
src/pybind/mgr/mgr_module.py surface over the src/mgr/ActivePyModules.cc
host role).

The reference's mgr is an extension substrate, not a fixed daemon: the
autoscaler, balancer, prometheus, dashboard are all Python modules
loaded into the mgr process against one narrow API. This module defines
that seam for the TPU build:

- subclass :class:`MgrModule`, override what you need:
  * ``COMMANDS`` — admin-socket commands this module serves
    (MonCommand descriptor role); dispatched to ``handle_command``.
  * ``serve()`` — optional long-running coroutine, started by the host
    (one task per module, cancelled at shutdown).
  * ``notify(what, ident)`` — change notifications ("osd_map" on a new
    epoch, "reports" per MMgrReport, ActivePyModules::notify_all role).
  * ``shutdown()`` — cleanup hook.
- host services available on ``self``:
  * ``get(what)`` — structured cluster state ("osd_map", "reports",
    "status", "health" — ActivePyModules::get role).
  * ``get_store(key)`` / ``set_store(key, value)`` — persistent
    per-module KV, backed by the mon's central config DB (the
    MonKVStore role: survives mgr restarts, replicated with the mon).
  * ``send_mon(msg)`` — submit a mutation to the mon (hunting send).
  * ``get_module_option(name, default)`` — per-module configuration.

Third-party modules drop a ``.py`` file exposing a ``Module`` class
into a module directory; ``MgrLite.load_modules_from(dir)`` loads them
(the ActivePyModules dlopen-equivalent).

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/mgr_module.py``.
"""
from __future__ import annotations

import asyncio
import importlib.util
import sys
from pathlib import Path
from typing import Any


class MgrModule:
    """Base class every mgr module subclasses (mgr_module.py:MgrModule
    role)."""

    #: admin-socket command descriptors: {"cmd": name, "desc": help}
    COMMANDS: list[dict] = []
    #: declarative module options: {"name": ..., "default": ...}
    MODULE_OPTIONS: list[dict] = []

    def __init__(self, name: str, host: "Any"):
        self.module_name = name
        self._host = host

    # ------------------------------------------------ host services

    def get(self, what: str):
        """Structured cluster state (ActivePyModules::get role)."""
        return self._host.module_get(what)

    def get_store(self, key: str, default=None):
        """Persistent module KV read (get_store role) — served from the
        central config-DB mirror."""
        return self._host.module_get_store(self.module_name, key,
                                           default)

    async def set_store(self, key: str, value: str | None) -> None:
        """Persistent module KV write (set_store role) — committed
        through the mon so it survives mgr restarts."""
        await self._host.module_set_store(self.module_name, key, value)

    async def send_mon(self, msg) -> None:
        await self._host.module_send_mon(msg)

    def get_module_option(self, name: str, default=None):
        for opt in self.MODULE_OPTIONS:
            if opt["name"] == name:
                stored = self.get_store(f"option/{name}")
                if stored is not None:
                    return stored
                return opt.get("default", default)
        stored = self.get_store(f"option/{name}")
        return stored if stored is not None else default

    def log(self, msg: str) -> None:
        self._host.module_log(self.module_name, msg)

    # ------------------------------------------------ overridables

    async def serve(self) -> None:
        """Optional long-running loop (Module.serve role); the default
        returns immediately (pure command/notify modules)."""

    async def shutdown(self) -> None:
        """Cleanup before the host stops (Module.shutdown role)."""

    def notify(self, what: str, ident) -> None:
        """Change notification (notify_all role): what is "osd_map"
        (ident = epoch) or "reports" (ident = osd id)."""

    async def handle_command(self, cmd: str, args: dict):
        """Dispatch for this module's COMMANDS."""
        raise NotImplementedError(cmd)


def load_module_file(path: str | Path):
    """Import a drop-in module file and return its ``Module`` class
    (the ActivePyModules load-from-disk role)."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(
        f"ceph_tpu_mgr_module_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load mgr module from {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    cls = getattr(mod, "Module", None)
    if cls is None or not issubclass(cls, MgrModule):
        raise ImportError(
            f"{path}: no Module(MgrModule) class exported")
    return cls


class ModuleHost:
    """Mixin holding the module registry + lifecycle (ActivePyModules
    role); MgrLite composes it with the stats/report machinery."""

    def __init__(self) -> None:
        self.modules: dict[str, MgrModule] = {}
        self._module_tasks: dict[str, asyncio.Task] = {}
        self._commands: dict[str, tuple[str, str]] = {}  # cmd->(mod,desc)

    def load_module(self, name: str, cls: type[MgrModule]) -> MgrModule:
        if name in self.modules:
            raise ValueError(f"mgr module {name!r} already loaded")
        inst = cls(name, self)
        self.modules[name] = inst
        for c in cls.COMMANDS:
            self._commands[c["cmd"]] = (name, c.get("desc", ""))
            # a module loaded AFTER the admin socket came up must still
            # reach the socket (the host hook registers live)
            self._command_added(c["cmd"], c.get("desc", ""))
        if self._started():
            self._start_module(inst)
        return inst

    def _command_added(self, cmd: str, desc: str) -> None:
        """Hook: a command became available after construction."""

    def load_modules_from(self, directory: str | Path) -> list[str]:
        """Load every ``*.py`` drop-in in ``directory`` (third-party
        module dir role); returns the loaded names."""
        loaded = []
        for path in sorted(Path(directory).glob("*.py")):
            name = path.stem
            self.load_module(name, load_module_file(path))
            loaded.append(name)
        return loaded

    def _start_module(self, inst: MgrModule) -> None:
        self._module_tasks[inst.module_name] = \
            asyncio.get_running_loop().create_task(self._serve(inst))

    async def _serve(self, inst: MgrModule) -> None:
        try:
            await inst.serve()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # a broken module must not kill the mgr
            self.module_log(inst.module_name, f"serve() died: {e!r}")

    def _start_all_modules(self) -> None:
        for inst in self.modules.values():
            self._start_module(inst)

    async def _stop_all_modules(self) -> None:
        for name, inst in self.modules.items():
            try:
                await inst.shutdown()
            except Exception:
                pass
            t = self._module_tasks.pop(name, None)
            if t is not None:
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass

    def notify_all(self, what: str, ident) -> None:
        """Fan a change notification to every module
        (ActivePyModules::notify_all role); module exceptions are
        contained."""
        for inst in self.modules.values():
            try:
                inst.notify(what, ident)
            except Exception as e:
                self.module_log(inst.module_name,
                                f"notify({what}) died: {e!r}")

    async def dispatch_command(self, cmd: str, args: dict):
        """Route an admin command to the module that registered it."""
        owner = self._commands.get(cmd)
        if owner is None:
            raise KeyError(f"no mgr module serves {cmd!r}")
        return await self.modules[owner[0]].handle_command(cmd, args)

    # subclass obligations (MgrLite provides these)

    def _started(self) -> bool:
        raise NotImplementedError

    def module_get(self, what: str):
        raise NotImplementedError

    def module_get_store(self, module: str, key: str, default):
        raise NotImplementedError

    async def module_set_store(self, module: str, key: str,
                               value: str | None) -> None:
        raise NotImplementedError

    async def module_send_mon(self, msg) -> None:
        raise NotImplementedError

    def module_log(self, module: str, msg: str) -> None:
        raise NotImplementedError
