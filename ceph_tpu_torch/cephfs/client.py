"""CephFS client — libcephfs-style mount + POSIX ops.

The port's copy of ``ceph_tpu.cephfs.client``.

Reference behavior re-created (``src/client/Client.cc``,
``libcephfs.h``; SURVEY.md §3.9):

- **mount**: subscribe to the FSMap, find the filesystem's rank-0
  active MDS, open a session;
- **metadata** goes through MClientRequest RPC to the MDS with
  path-walk lookups cached as dentries (dropped on failover);
- **file data** never touches the MDS: reads/writes map logical byte
  ranges through the striper onto ``<ino-hex>.<objno-08x>`` objects in
  the data pool, exactly the reference's object naming;
- **failover**: a dead MDS connection re-resolves the active from the
  FSMap and resends in-flight requests under their original tids —
  the MDS's journaled completed-request set makes resends idempotent;
- **cap-flush analog**: size/mtime propagate to the MDS via setattr on
  close/fsync (the reference's Fw dirty-cap flush).
"""

from __future__ import annotations

import threading
import time
import uuid

from ..mds import messages as M
from ..mds.daemon import ROOT_INO, data_oid
from ..mds.fsmap import FSMap
from ..mon.client import MonClient
from ..msg import Dispatcher, EntityAddr, Messenger
from ..osdc.librados import Error, IoCtx, ObjectNotFound, Rados
from ..osdc.striper import FileLayout, file_to_extents


class CephFSError(OSError):
    def __init__(self, rc: int, msg: str = ""):
        super().__init__(-rc, msg or f"rc={rc}")
        self.rc = rc


def _split(path: str) -> list[str]:
    return [p for p in path.split("/") if p]


class _Fd:
    def __init__(self, path, parent_ino, name, rec, mode,
                 snap: str | None = None):
        self.path = path
        self.parent_ino = parent_ino
        self.name = name
        self.rec = dict(rec)
        self.mode = mode
        self.dirty = False
        self.snap = snap        # pool-snap name when opened via .snap


class CephFS(Dispatcher):
    """One mounted filesystem (reference ``struct ceph_mount_info``)."""

    def __init__(self, monmap, fs_name: str | None = None,
                 entity: str | None = None,
                 default_layout: FileLayout | None = None,
                 auth=None):
        self.monmap = monmap
        self.fs_name = fs_name
        self.auth = auth
        # entity names MUST be process-unique: the MDS dedups
        # requests by (client, tid), and an id()-derived name can
        # recur when Python reuses a freed address — a later client
        # then gets answered from an earlier client's completed map
        self.entity = entity or f"client.fs{uuid.uuid4().hex[:12]}"
        self.default_layout = default_layout or FileLayout()
        self.monc = MonClient(monmap, entity=self.entity, auth=auth)
        self.msgr = Messenger(
            self.entity,
            **(auth.msgr_kwargs(self.entity) if auth else {}))
        self.msgr.add_dispatcher(self)
        self.rados: Rados | None = None
        self.data: IoCtx | None = None
        self.fsmap = FSMap()
        self.fscid = -1
        self._mds_cons: dict[int, object] = {}
        self._lock = threading.Lock()
        # ino → owning MDS rank (subtree partition by top-level dir;
        # populated as paths resolve — rank 0 owns the root)
        self._owner: dict[int, int] = {ROOT_INO: 0}
        self._tid = 0
        self._waiters: dict[int, tuple[threading.Event, list]] = {}
        self._dcache: dict[tuple[int, str],
                   tuple[dict, float]] = {}
        self._fds: dict[int, _Fd] = {}
        self._next_fd = 3
        self.mounted = False

    # -- mount / session ---------------------------------------------------
    def mount(self, timeout: float = 20.0) -> "CephFS":
        self.monc.on_fsmap = self._on_fsmap
        self.monc.sub_want("fsmap", 0)
        self.monc.wait_for_fsmap(1, timeout)
        deadline = time.monotonic() + timeout
        fs = None
        while time.monotonic() < deadline:
            with self._lock:
                fs = (self.fsmap.fs_by_name(self.fs_name)
                      if self.fs_name else
                      next(iter(self.fsmap.filesystems.values()), None))
                if fs is not None and \
                        self.fsmap.active_for(fs.fscid) is not None:
                    break
            time.sleep(0.05)
        else:
            raise TimeoutError(f"no active MDS for {self.fs_name!r}")
        self.fscid = fs.fscid
        self.rados = Rados(self.monmap,
                           name=f"{self.entity}-data",
                           auth=self.auth).connect()
        self.data = IoCtx(self.rados, fs.data_pool, "")
        self._connect_mds(timeout, rank=0)
        self.mounted = True
        return self

    def unmount(self):
        self.mounted = False
        for fd in list(self._fds):
            try:
                self.close(fd)
            except (CephFSError, TimeoutError, ConnectionError):
                pass
        for con in list(self._mds_cons.values()):
            try:
                con.send_message(M.MClientSession(
                    op="request_close", client=self.entity, seq=0))
            except ConnectionError:
                pass
        self._mds_cons.clear()
        if self.rados is not None:
            self.rados.shutdown()
            self.rados = None
        self.monc.shutdown()
        self.msgr.shutdown()

    def _on_fsmap(self, epoch: int, fsmap_dict: dict):
        with self._lock:
            self.fsmap = FSMap.from_dict(fsmap_dict)

    def _connect_mds(self, timeout: float = 20.0, rank: int = 0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                active = self.fsmap.active_for(self.fscid, rank)
            if active is not None:
                try:
                    con = self.msgr.connect_to(
                        EntityAddr(active.addr[0], active.addr[1]))
                    con.send_message(M.MClientSession(
                        op="request_open", client=self.entity, seq=1))
                    self._mds_cons[rank] = con
                    return
                except (ConnectionError, OSError):
                    pass
            time.sleep(0.1)
        raise TimeoutError(f"could not reach active MDS rank {rank}")

    def _max_mds(self) -> int:
        fs = self.fsmap.filesystems.get(self.fscid)
        return max(1, fs.max_mds) if fs is not None else 1

    def _rank_of_dir(self, dino: int) -> int:
        """The rank owning ops INSIDE directory `dino` (ranks
        partition by top-level directory; root itself is rank 0).
        The owner map stores the RAW subtree hash and reduces by the
        CURRENT max_mds here — a max_mds change instantly re-routes
        even fd-based ops (fsync/close) that skip path resolution."""
        return self._owner.get(dino, 0) % self._max_mds()

    def _note_child(self, parent_ino: int, name: str, child_ino: int):
        """Record subtree ownership as paths resolve: a top-level
        directory starts its own subtree (raw crc32, reduced at use
        time); deeper entries inherit."""
        import zlib
        if parent_ino == ROOT_INO:
            self._owner[child_ino] = zlib.crc32(name.encode())
        else:
            self._owner[child_ino] = self._owner.get(parent_ino, 0)

    # -- RPC ---------------------------------------------------------------
    def _request(self, op: str, args: dict, timeout: float = 20.0,
                 rank: int | None = None):
        """Send one metadata op to its subtree's rank; survive MDS
        failover by re-resolving the active and resending under the
        same tid."""
        if rank is None:
            rank = self._rank_of_dir(args.get("dir", ROOT_INO))
        with self._lock:
            self._tid += 1
            tid = self._tid
            ev = threading.Event()
            self._waiters[tid] = (ev, [])
        msg = M.MClientRequest(tid=tid, client=self.entity, op=op,
                               args=args)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            con = self._mds_cons.get(rank)
            try:
                if con is None:
                    raise ConnectionError("no mds session")
                con.send_message(msg)
            except (ConnectionError, OSError):
                self._mds_cons.pop(rank, None)
                self._dcache.clear()
                try:
                    self._connect_mds(
                        max(0.2, deadline - time.monotonic()),
                        rank=rank)
                except TimeoutError:
                    break
                continue
            if ev.wait(min(2.0, max(0.1, deadline - time.monotonic()))):
                with self._lock:
                    _, box = self._waiters.pop(tid)
                reply = box[0]
                if reply.rc == -108:     # target went standby mid-op
                    with self._lock:
                        self._waiters[tid] = (ev, box)
                        box.clear()
                        ev.clear()
                    self._mds_cons.pop(rank, None)
                    continue
                if reply.rc != 0:
                    raise CephFSError(reply.rc, reply.outs or "")
                return reply.result
            # silence: connection may be dead (killed MDS) — probe it
            if con is not None and not con.is_connected:
                self._mds_cons.pop(rank, None)
        with self._lock:
            self._waiters.pop(tid, None)
        raise TimeoutError(f"mds op {op} timed out (rank {rank})")

    def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, M.MClientReply):
            with self._lock:
                waiter = self._waiters.get(msg.tid)
                if waiter:
                    waiter[1].append(msg)
                    waiter[0].set()
            return True
        if isinstance(msg, M.MClientSession):
            return True
        return False

    def ms_handle_reset(self, con):
        for rank, c in list(self._mds_cons.items()):
            if c is con:
                self._mds_cons.pop(rank, None)

    # -- path resolution ---------------------------------------------------
    def _resolve_dir(self, parts: list[str],
                     _hops: int = 0, base: int = ROOT_INO) -> int:
        """Walk to the directory holding parts[-1]; → its ino.
        Directory symlinks in intermediate components are followed
        (POSIX resolution; bounded: ELOOP)."""
        ino = base
        i = 0
        while i < len(parts) - 1:
            name = parts[i]
            rec = self._lookup(ino, name)
            if rec["type"] == "symlink":
                _hops += 1
                if _hops > 8:
                    raise CephFSError(-40, "too many symlink hops")
                target = rec["target"]
                tparts = _split(target)
                # splice the link target in place of this component;
                # absolute targets restart from /
                rest = parts[i + 1:]
                parts = tparts + rest
                i = 0
                ino = ROOT_INO if target.startswith("/") else ino
                continue
            if rec["type"] != "dir":
                raise CephFSError(-20, f"{name!r} is not a directory")
            ino = rec["ino"]
            i += 1
        return ino

    DCACHE_LEASE = 1.0   # seconds a cached dentry stays trusted
    # (reference: MDS-issued dentry leases / caps bound client cache
    # staleness; a fixed client-side lease is the slice analog — two
    # clients of one fs converge within a lease, not never)

    def _lookup(self, dino: int, name: str) -> dict:
        key = (dino, name)
        hit = self._dcache.get(key)
        rec = None
        if hit is not None:
            rec, stamp = hit
            if rec.get("remote") or \
                    time.monotonic() - stamp > self.DCACHE_LEASE:
                # hard-linked inodes always re-fetch (their size lives
                # on the shared inode row); plain entries expire with
                # the lease
                rec = None
        if rec is None:
            rec = self._request("lookup", {"dir": dino, "name": name})
            self._dcache[key] = (rec, time.monotonic())
        self._note_child(dino, name, rec["ino"])
        return rec

    def _resolve(self, path: str) -> tuple[int, str, dict]:
        """→ (parent_ino, name, rec); root is (1, "", root_rec)."""
        parts = _split(path)
        if not parts:
            return ROOT_INO, "", {"ino": ROOT_INO, "type": "dir",
                                  "size": 0, "mtime": 0}
        dino = self._resolve_dir(parts)
        return dino, parts[-1], self._lookup(dino, parts[-1])

    # -- namespace ops -----------------------------------------------------
    def mkdir(self, path: str):
        parts = _split(path)
        if not parts:
            raise CephFSError(-17, "/ exists")
        sp = self._snap_split(parts)
        if sp is not None:
            base, snap, rest = sp
            if snap is not None and not rest:
                # `mkdir dir/.snap/name` IS snapshot creation
                self.mksnap("/".join(base), snap)
                return
            raise CephFSError(-30, "snapshots are read-only")
        dino = self._resolve_dir(parts)
        rec = self._request("mkdir", {"dir": dino, "name": parts[-1]})
        self._dcache[(dino, parts[-1])] = (rec, time.monotonic())
        self._note_child(dino, parts[-1], rec["ino"])

    def mkdirs(self, path: str):
        parts = _split(path)
        for i in range(1, len(parts) + 1):
            try:
                self.mkdir("/".join(parts[:i]))
            except CephFSError as e:
                if e.rc != -17:
                    raise

    def readdir(self, path: str) -> list[tuple[str, dict]]:
        sp = self._snap_split(_split(path))
        if sp is not None:
            base, snap, rest = sp
            if snap is None:
                # listing the .snap pseudo-dir: the snapshots
                return [(s["name"], {"ino": 0, "type": "dir",
                                     "size": 0,
                                     "mtime": s.get("created", 0)})
                        for s in self.lssnap("/".join(base))]
            info, rec = self._snap_resolve(base, snap, rest)
            if rec["type"] != "dir":
                raise CephFSError(-20, f"{path!r} is not a directory")
            out = self._request("snap_readdir", {
                "snapid": info["snapid"], "dir": rec["ino"]})
            return [(name, r) for name, r in out]
        _, _, rec = self._resolve(path)
        if rec["type"] != "dir":
            raise CephFSError(-20, f"{path!r} is not a directory")
        out = self._request("readdir", {"dir": rec["ino"]})
        return [(name, r) for name, r in out]

    def listdir(self, path: str) -> list[str]:
        return [name for name, _ in self.readdir(path)]

    # -- snapshots (.snap; reference kernel-client .snap dirs) -------------
    def _dir_ino(self, parts: list[str]) -> int:
        """Resolve a full path to a DIRECTORY ino."""
        if not parts:
            return ROOT_INO
        dino = self._resolve_dir(parts)
        rec = self._lookup(dino, parts[-1])
        if rec["type"] != "dir":
            raise CephFSError(-20, "not a directory")
        return rec["ino"]

    def _snap_split(self, parts: list[str]):
        """Path containing ``.snap`` → (base_parts, snapname|None,
        rest_parts); None when the path has no .snap component."""
        if ".snap" not in parts:
            return None
        i = parts.index(".snap")
        snap = parts[i + 1] if len(parts) > i + 1 else None
        return parts[:i], snap, parts[i + 2:]

    def _snap_resolve(self, base: list[str], snap: str,
                      rest: list[str]):
        """→ (info, rec) for a path inside a snapshot: walk `rest`
        through the frozen manifests starting at the snapped dir."""
        dino = self._dir_ino(base)
        info = self._request("snapinfo", {"dir": dino, "snap": snap})
        rec = {"ino": dino, "type": "dir", "size": 0, "mtime": 0}
        cur = dino
        for j, name in enumerate(rest):
            rec = self._request("snap_lookup", {
                "snapid": info["snapid"], "dir": cur, "name": name})
            if rec["type"] == "dir":
                cur = rec["ino"]
            elif j != len(rest) - 1:
                raise CephFSError(-20, f"{name!r} is not a directory")
        return info, rec

    def mksnap(self, path: str, name: str) -> dict:
        """Snapshot the directory at `path` (``mkdir dir/.snap/name``
        equivalent)."""
        return self._request("mksnap", {
            "dir": self._dir_ino(_split(path)), "name": name})

    def rmsnap(self, path: str, name: str):
        self._request("rmsnap", {
            "dir": self._dir_ino(_split(path)), "name": name})

    def lssnap(self, path: str) -> list[dict]:
        return self._request("lssnap", {
            "dir": self._dir_ino(_split(path))})

    def stat(self, path: str) -> dict:
        parts = _split(path)
        sp = self._snap_split(parts)
        if sp is not None:
            base, snap, rest = sp
            if snap is None:
                self._dir_ino(base)      # ENOENT on a phantom base
                return {"ino": 0, "type": "dir", "size": 0,
                        "mtime": 0}      # the .snap pseudo-dir
            _info, rec = self._snap_resolve(base, snap, rest)
            return rec
        _, _, rec = self._resolve(path)
        for fd in self._fds.values():
            if fd.rec["ino"] == rec["ino"] and fd.dirty:
                return dict(fd.rec)     # unflushed size is newer
        return rec

    def unlink(self, path: str):
        if ".snap" in _split(path):
            raise CephFSError(-30, "snapshots are read-only")
        dino, name, _rec = self._resolve(path)
        self._request("unlink", {"dir": dino, "name": name})
        self._dcache.pop((dino, name), None)

    def rmdir(self, path: str):
        sp = self._snap_split(_split(path))
        if sp is not None:
            base, snap, rest = sp
            if snap is not None and not rest:
                # `rmdir dir/.snap/name` IS snapshot removal
                self.rmsnap("/".join(base), snap)
                return
            raise CephFSError(-30, "snapshots are read-only")
        dino, name, _rec = self._resolve(path)
        self._request("rmdir", {"dir": dino, "name": name})
        self._dcache.pop((dino, name), None)

    def _follow_symlinks(self, dino: int, name: str
                         ) -> tuple[int, str]:
        """Resolve (dino, name) through symlink dentries (bounded:
        ELOOP).  Relative targets resolve against the LINK's parent
        directory, absolute ones from /.  A missing dentry stops the
        walk — open('w') may be about to create it."""
        hops = 0
        while True:
            try:
                rec = self._lookup(dino, name)
            except CephFSError as e:
                if e.rc == -2:
                    return dino, name
                raise
            if rec["type"] != "symlink":
                return dino, name
            hops += 1
            if hops > 8:
                raise CephFSError(-40, "too many symlink hops")
            target = rec["target"]
            parts = _split(target)
            if not parts:
                raise CephFSError(-21, "/ is a directory")
            base = ROOT_INO if target.startswith("/") else dino
            # _resolve_dir follows directory symlinks in the target's
            # intermediate components too (POSIX resolution)
            dino = self._resolve_dir(parts, _hops=hops, base=base)
            name = parts[-1]

    def symlink(self, target: str, path: str):
        """Create a symbolic link at `path` pointing to `target`
        (reference Client::symlink)."""
        parts = _split(path)
        if not parts:
            raise CephFSError(-17, "/ exists")
        dino = self._resolve_dir(parts)
        rec = self._request("symlink", {
            "dir": dino, "name": parts[-1], "target": target})
        self._dcache[(dino, parts[-1])] = (rec, time.monotonic())

    def readlink(self, path: str) -> str:
        _, _, rec = self._resolve(path)
        if rec["type"] != "symlink":
            raise CephFSError(-22, f"{path!r} is not a symlink")
        return rec["target"]

    def link(self, src: str, dst: str):
        """Hard link: `dst` becomes another name for `src`'s inode
        (reference Client::link)."""
        sparts, dparts = _split(src), _split(dst)
        if not sparts or not dparts:
            raise CephFSError(-22, "cannot link /")
        tdino = self._resolve_dir(sparts)
        ddino = self._resolve_dir(dparts)
        if self._rank_of_dir(tdino) != self._rank_of_dir(ddino):
            raise CephFSError(-18, "hard link across MDS subtrees")
        self._request("link", {
            "tdir": tdino, "tname": sparts[-1],
            "dir": ddino, "name": dparts[-1]})
        # both names now resolve through the shared inode row
        self._dcache.pop((tdino, sparts[-1]), None)
        self._dcache.pop((ddino, dparts[-1]), None)

    def rename(self, src: str, dst: str):
        if ".snap" in _split(src) or ".snap" in _split(dst):
            raise CephFSError(-30, "snapshots are read-only")
        sparts, dparts = _split(src), _split(dst)
        if not sparts or not dparts:
            raise CephFSError(-22, "cannot rename /")
        sdino = self._resolve_dir(sparts)
        ddino = self._resolve_dir(dparts)
        if self._rank_of_dir(sdino) != self._rank_of_dir(ddino):
            # the two directories live in different MDS subtrees:
            # cross-rank rename would need the reference Migrator's
            # distributed transaction — EXDEV, like rename across
            # mounts (callers fall back to copy+unlink)
            raise CephFSError(-18, "rename across MDS subtrees")
        # rename args carry sdir/ddir (no "dir" key), so the rank
        # must be explicit or _request would default to rank 0
        self._request("rename", {
            "sdir": sdino, "sname": sparts[-1],
            "ddir": ddino, "dname": dparts[-1]},
            rank=self._rank_of_dir(sdino))
        self._dcache.pop((sdino, sparts[-1]), None)
        self._dcache.pop((ddino, dparts[-1]), None)

    # -- file I/O ----------------------------------------------------------
    def open(self, path: str, flags: str = "r",
             layout: FileLayout | None = None) -> int:
        """flags: 'r', 'w' (create+truncate), 'a', 'x' (excl create)."""
        parts = _split(path)
        if not parts:
            raise CephFSError(-21, "/ is a directory")
        sp = self._snap_split(parts)
        if sp is not None:
            if flags != "r":
                raise CephFSError(-30, "snapshots are read-only")
            base, snap, rest = sp
            if snap is None or not rest:
                raise CephFSError(-21, f"{path!r} is a directory")
            info, rec = self._snap_resolve(base, snap, rest)
            if rec["type"] != "file":
                raise CephFSError(-21, f"{path!r} is a directory")
            fd = self._next_fd
            self._next_fd += 1
            self._fds[fd] = _Fd(path, 0, rest[-1], rec, "r",
                                snap=info["pool_snap"])
            return fd
        dino = self._resolve_dir(parts)
        name = parts[-1]
        if flags != "x":
            # follow symlinks for read/write/append — a write through
            # a link must land on the target, not on the link's own
            # inode.  O_CREAT|O_EXCL ('x') must NOT follow: POSIX
            # requires EEXIST when the final component is a symlink,
            # even a dangling one
            dino, name = self._follow_symlinks(dino, name)
        if flags in ("w", "a", "x"):
            lay = layout or self.default_layout
            args = {"dir": dino, "name": name,
                    "layout": {"stripe_unit": lay.stripe_unit,
                               "stripe_count": lay.stripe_count,
                               "object_size": lay.object_size}}
            if flags == "x":
                args["excl"] = True
            rec = self._request("create", args)
            self._dcache[(dino, name)] = (rec, time.monotonic())
            self._note_child(dino, name, rec["ino"])
            if flags == "w" and rec.get("size", 0):
                rec = self._truncate_fd_rec(dino, name, rec, 0)
        else:
            rec = self._lookup(dino, name)
            if rec["type"] != "file":
                raise CephFSError(-21, f"{path!r} is a directory")
        fd = self._next_fd
        self._next_fd += 1
        self._fds[fd] = _Fd(path, dino, name, rec,
                            "r" if flags == "r" else "w")
        return fd

    def _layout_of(self, rec: dict) -> FileLayout:
        lay = rec.get("layout")
        if not lay:
            return self.default_layout
        return FileLayout(stripe_unit=lay["stripe_unit"],
                          stripe_count=lay["stripe_count"],
                          object_size=lay["object_size"])

    def write(self, fd: int, data: bytes, offset: int | None = None
              ) -> int:
        f = self._fd(fd, "w")
        off = offset if offset is not None else f.rec.get("size", 0)
        layout = self._layout_of(f.rec)
        for ext in file_to_extents(layout, off, len(data)):
            lo = ext.logical_offset - off
            self.data.write(data_oid(f.rec["ino"], ext.object_no),
                            data[lo:lo + ext.length], off=ext.offset)
        end = off + len(data)
        if end > f.rec.get("size", 0):
            f.rec["size"] = end
        f.rec["mtime"] = time.time()
        f.dirty = True
        return len(data)

    def read(self, fd: int, size: int | None = None,
             offset: int = 0) -> bytes:
        f = self._fd(fd, None)
        fsize = f.rec.get("size", 0)
        if size is None:
            size = max(0, fsize - offset)
        size = min(size, max(0, fsize - offset))
        if size == 0:
            return b""
        layout = self._layout_of(f.rec)
        out = bytearray(size)
        for ext in file_to_extents(layout, offset, size):
            oid = data_oid(f.rec["ino"], ext.object_no)
            try:
                if f.snap is not None:
                    # snapshot read: the OSD serves the pool-snap
                    # clone (COW — reference SnapContext reads)
                    chunk = self.data.snap_read(
                        oid, f.snap, length=ext.length,
                        off=ext.offset)
                else:
                    chunk = self.data.read(
                        oid, length=ext.length, off=ext.offset)
            except ObjectNotFound:
                chunk = b""                  # hole
            lo = ext.logical_offset - offset
            out[lo:lo + len(chunk)] = chunk
        return bytes(out)

    def fsync(self, fd: int):
        f = self._fd(fd, None)
        if f.dirty:
            rec = self._request("setattr", {
                "dir": f.parent_ino, "name": f.name,
                "size": f.rec["size"], "mtime": f.rec["mtime"]})
            f.rec = dict(rec)
            self._dcache[(f.parent_ino, f.name)] = (rec, time.monotonic())
            f.dirty = False

    def close(self, fd: int):
        self.fsync(fd)
        self._fds.pop(fd, None)

    def truncate(self, path: str, size: int):
        dino, name, rec = self._resolve(path)
        self._truncate_fd_rec(dino, name, rec, size)

    def _truncate_fd_rec(self, dino, name, rec, size) -> dict:
        old = rec.get("size", 0)
        new = self._request("setattr", {"dir": dino, "name": name,
                                        "size": size,
                                        "mtime": time.time()})
        self._dcache[(dino, name)] = (new, time.monotonic())
        if size < old:
            layout = self._layout_of(rec)
            first_dead = -(-size // layout.object_size)
            last = max(0, -(-old // layout.object_size))
            for objno in range(first_dead, last):
                try:
                    self.data.remove(data_oid(rec["ino"], objno))
                except (ObjectNotFound, Error):
                    pass
            if size % layout.object_size and size > 0:
                objno = size // layout.object_size
                try:
                    self.data.truncate(data_oid(rec["ino"], objno),
                                       size % layout.object_size)
                except (ObjectNotFound, Error):
                    pass
        return new

    # -- helpers -----------------------------------------------------------
    def _fd(self, fd: int, need: str | None) -> _Fd:
        f = self._fds.get(fd)
        if f is None:
            raise CephFSError(-9, f"bad fd {fd}")
        if need == "w" and f.mode != "w":
            raise CephFSError(-9, "fd not open for write")
        return f

    def write_file(self, path: str, data: bytes,
                   layout: FileLayout | None = None):
        fd = self.open(path, "w", layout=layout)
        try:
            self.write(fd, data, 0)
        finally:
            self.close(fd)

    def read_file(self, path: str) -> bytes:
        fd = self.open(path, "r")
        try:
            return self.read(fd)
        finally:
            self.close(fd)
