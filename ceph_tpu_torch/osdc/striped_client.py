"""RadosStriper: striped large-object API over RadosClient (the
libradosstriper role, src/libradosstriper/RadosStriperImpl.cc).

A logical striped object ``name`` is cut by a FileLayout across RADOS
objects ``<name>.%08x``. Writes fan out to every touched object
concurrently (one asyncio gather — the striping parallelism is the
point); partial-object updates ride the PG op-vector engine's atomic
server-side read-modify-write. Logical size is tracked in a
size-carrying header object, mirroring the reference's XATTR_SIZE
usage.

ceph_tpu_torch's own copy of ``ceph_tpu/osdc/striped_client.py``.
"""
from __future__ import annotations

import asyncio

from .striper import (
    FileLayout,
    StripedReadResult,
    file_to_extents,
    get_num_objects,
)


class RadosStriper:
    def __init__(self, client, pool_id: int,
                 layout: FileLayout | None = None):
        self.client = client
        self.pool_id = pool_id
        self.layout = layout or FileLayout(
            stripe_unit=1 << 20, stripe_count=4, object_size=1 << 22
        )

    def _fmt(self, name: str) -> str:
        return name + ".{objectno:08x}"

    def _size_oid(self, name: str) -> str:
        return name + ".size"

    async def _prefetch_targets(self, extents) -> None:
        """Warm the placement of every object a striped op touches in
        ONE coalesced resolver lookup (cluster/client.py
        resolve_targets): the N concurrent sub-ops below then hit the
        epoch-keyed cache instead of racing N separate misses.
        Best-effort — placement is never a liveness dependency."""
        resolve = getattr(self.client, "resolve_targets", None)
        if resolve is None:
            return
        try:
            await resolve(self.pool_id, [ex.oid for ex in extents])
        except Exception:
            pass  # the per-op path resolves (and retries) on its own

    # ------------------------------------------------------------ write

    async def write(self, name: str, data: bytes, offset: int = 0,
                    snapc=None) -> None:
        """``snapc`` (seq, [snap ids desc]) rides every RADOS write so
        the OSDs clone lazily when the striped object is covered by a
        snapshot (CephFS data-pool SnapContext role)."""
        extents = file_to_extents(
            self.layout, offset, len(data), self._fmt(name)
        )
        await self._prefetch_targets(extents)

        async def put(ex):
            piece = bytearray(ex.length)
            pos = 0
            for bo, ln in ex.buffer_extents:
                piece[pos : pos + ln] = data[bo : bo + ln]
                pos += ln
            # server-side partial write: the PG's op-vector engine does
            # the read-modify-write atomically (EC pools rebuild the
            # full object state primary-side)
            await self.client.write(
                self.pool_id, ex.oid, ex.offset, bytes(piece),
                snapc=snapc,
            )

        await asyncio.gather(*(put(ex) for ex in extents))
        new_end = offset + len(data)
        if new_end > await self.stat(name):
            await self.client.write_full(
                self.pool_id, self._size_oid(name),
                new_end.to_bytes(8, "little"), snapc=snapc,
            )


    # ------------------------------------------------------------- read

    async def read(self, name: str, offset: int = 0,
                   length: int = -1, snapid=None) -> bytes:
        if length < 0:
            size = await self.stat(name)
            length = max(0, size - offset)
        if length == 0:
            return b""
        extents = file_to_extents(
            self.layout, offset, length, self._fmt(name)
        )
        await self._prefetch_targets(extents)
        result = StripedReadResult(length)

        async def get(ex):
            try:
                data = await self.client.read(
                    self.pool_id, ex.oid, offset=ex.offset,
                    length=ex.length, snapid=snapid
                )
            except KeyError:
                data = b""  # hole: zero-fill
            result.add_partial_result(data, ex.buffer_extents)

        await asyncio.gather(*(get(ex) for ex in extents))
        return result.assemble()

    async def pread(self, name: str, offset: int,
                    length: int) -> tuple[bytes, int]:
        """Bounded read + logical size in ONE concurrent fan-out (the
        extent gets and the size-header get ride the same gather, so
        callers that need EOF semantics — e.g. the sqlite VFS short
        read — pay one round-trip latency, not two)."""
        size_task = asyncio.ensure_future(self.stat(name))
        try:
            data = await self.read(name, offset, max(0, length))
        except BaseException:
            size_task.cancel()
            try:  # retrieve its result: no orphaned-exception warning
                await size_task
            except BaseException:
                pass
            raise
        size = await size_task
        avail = max(0, min(length, size - offset))
        return data[:avail], size

    # ------------------------------------------------------------- meta

    async def stat(self, name: str) -> int:
        """Logical size in bytes (0 when never written)."""
        try:
            raw = await self.client.read(
                self.pool_id, self._size_oid(name)
            )
            return int.from_bytes(raw[:8], "little")
        except KeyError:
            return 0

    async def truncate(self, name: str, size: int, snapc=None) -> None:
        """Cut the logical file at ``size``: covering objects shrink to
        the last stripe-extent the new size still reaches, objects past
        it are removed (RadosStriperImpl::truncate role)."""
        old = await self.stat(name)
        if size >= old:
            if size > old:
                await self.client.write_full(
                    self.pool_id, self._size_oid(name),
                    size.to_bytes(8, "little"), snapc=snapc)
            return
        fmt = self._fmt(name)
        # only objects overlapping the CUT range [size, old) need an
        # op (touching the kept range would also materialize hole
        # objects, since the OSD truncate op creates-if-missing)
        affected = {ex.oid
                    for ex in file_to_extents(self.layout, size,
                                              old - size, fmt)}
        # kept tail length of each boundary object: the LAST kept byte
        # an object holds comes from the final stripe row before the
        # cut, so one stripe period of extents suffices — walking the
        # whole kept prefix would make every shrink O(file size)
        keep: dict[bytes, int] = {}
        if size > 0:
            period = self.layout.stripe_unit * self.layout.stripe_count
            lo = max(0, size - period)
            for ex in file_to_extents(self.layout, lo, size - lo, fmt):
                keep[ex.oid] = max(keep.get(ex.oid, 0),
                                   ex.offset + ex.length)

        async def cut(oid: bytes):
            if oid in keep:  # boundary object: shrink to its kept tail
                await self.client.truncate(self.pool_id, oid,
                                           keep[oid], snapc=snapc)
            else:
                try:
                    await self.client.delete(self.pool_id, oid,
                                             snapc=snapc)
                except KeyError:
                    pass

        await asyncio.gather(*(cut(oid) for oid in affected))
        await self.client.write_full(
            self.pool_id, self._size_oid(name),
            size.to_bytes(8, "little"), snapc=snapc)

    async def exists(self, name: str) -> bool:
        """True once the striped file has ever been written (its size
        header object exists)."""
        try:
            await self.client.stat(self.pool_id, self._size_oid(name))
            return True
        except KeyError:
            return False

    async def remove(self, name: str, snapc=None) -> None:
        """``snapc`` preserves snapshot clones through the delete (the
        head becomes a whiteout; snap reads keep working)."""
        size = await self.stat(name)
        n = get_num_objects(self.layout, size)
        fmt = self._fmt(name)

        async def rm(oid):
            try:
                await self.client.delete(self.pool_id, oid,
                                         snapc=snapc)
            except KeyError:
                pass

        await asyncio.gather(
            *(rm(fmt.format(objectno=i).encode()) for i in range(n)),
            rm(self._size_oid(name)),
        )
