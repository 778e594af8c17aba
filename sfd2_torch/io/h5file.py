"""HDF5 files for the feature and match stores, read and written without h5py.

The stores need a small part of HDF5, the part h5py writes by default
(``libver=('earliest', ...)``): superblock version 0 (1 is read too),
version-1 object headers with continuation messages, old-style groups (the
symbol-table message, the version-1 group B-tree, symbol-table nodes and the
local heap), dataspace messages v1 and v2, IEEE floats of 2, 4 and 8 bytes and
integers of 1, 2, 4 and 8 bytes, and data layout v3, contiguous or compact.
Attribute, fill-value and modification-time messages are skipped. Anything
else (chunked or filtered data, later superblocks, version-2 object headers,
link messages, variable-length types, ...) raises :class:`H5FileError`, which
names the file and the structure; nothing is read around it.

Reading. Opening a file reads the superblock only. A group's members are
indexed on its first lookup, by walking its B-tree and symbol-table nodes
into a name -> object-header map; an object header is parsed when that
object is first opened, and data is read when a dataset is indexed.
``keys()`` lists members in symbol-table order (byte order of the names),
which is h5py's order.

Writing uses the same layout, so h5py and hloc read the files. A dataset's
bytes and its object header are appended at the end of the file when it is
created. ``flush()`` and ``close()`` append new metadata (local heap,
symbol-table nodes, B-tree nodes, object header) for every group whose
members changed and for its ancestors, and only then rewrite the
superblock's root entry and end-of-file address. A writer that is killed
therefore leaves the file as it was at its last flush. Bytes that nothing
links to any more (an unlinked or overwritten group, a group's superseded
metadata) stay in the file; nothing reclaims them.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFF_FFFF_FFFF_FFFF
# Symbol-table node and group B-tree K of new files (HDF5's defaults): a
# node holds up to 2K entries, and is written at that size. An existing file
# keeps the K of its superblock.
LEAF_K, NODE_K = 4, 16
_FREE_NULL = 1  # a local heap's "no free block"
_LARGE = 1 << 20  # appends of at least this many bytes are written at once
_PENDING_MAX = 8 << 20

# One symbol-table entry: link-name heap offset, object header address,
# cache type, reserved, scratch pad (B-tree and heap addresses when cache
# type 1).
_ENTRY = np.dtype([("name", "<u8"), ("hdr", "<u8"), ("cache", "<u4"),
                   ("res", "<u4"), ("btree", "<u8"), ("heap", "<u8")])
# IEEE layouts: exponent location and size, mantissa location and size, bias.
_FLOAT = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}
_TYPE_CLASSES = ("fixed-point", "floating-point", "time", "string", "bitfield",
                 "opaque", "compound", "reference", "enum", "variable-length", "array")
# Object-header messages that are read (dataspace, datatype, layout,
# symbol table) or skipped (NIL, fill value old and new, attribute, comment,
# modification time old and new, attribute info).
_READ_MSGS = {0x01, 0x03, 0x08, 0x11}
_SKIP_MSGS = {0x00, 0x04, 0x05, 0x0C, 0x0D, 0x0E, 0x12, 0x15}
_MSG_NAMES = {0x02: "link info message (new-style group)",
              0x06: "link message (new-style group)",
              0x0A: "group info message (new-style group)",
              0x07: "external data files", 0x0B: "filter pipeline (filtered data)",
              0x16: "object reference count message"}
# The fill-value message h5py writes: version 2, allocation late, fill
# written if set, default fill value.
_FILL_MSG = b"\x02\x02\x02\x01\x00\x00\x00\x00"


class H5FileError(OSError):
    """A file, or a structure in it, that this module does not read."""


def is_hdf5(path: os.PathLike) -> bool:
    """True if the HDF5 signature is at offset 0, 512, 1024, 2048, ..."""
    path = Path(path)
    if not path.is_file():
        return False
    size = path.stat().st_size
    with open(path, "rb") as f:
        off = 0
        while off + len(SIGNATURE) <= size:
            f.seek(off)
            if f.read(len(SIGNATURE)) == SIGNATURE:
                return True
            off = 512 if off == 0 else 2 * off
    return False


def _padded(n: int) -> int:
    return (n + 7) & ~7


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    size = _padded(len(data))
    return struct.pack("<HHB3x", mtype, size, flags) + data.ljust(size, b"\0")


def _object_header(messages: bytes) -> bytes:
    """A version-1 object header: version, reserved, message count,
    reference count, chunk size, padding to 16; then the 8-aligned messages."""
    count, pos = 0, 0
    while pos < len(messages):
        count += 1
        pos += 8 + struct.unpack_from("<H", messages, pos + 2)[0]
    return struct.pack("<BBHII4x", 1, 0, count, 1, len(messages)) + messages


def _dtype_message(dt: np.dtype) -> bytes:
    size = dt.itemsize
    if dt.kind in "iu" and size in (1, 2, 4, 8):
        bits = 0x08 if dt.kind == "i" else 0x00
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dt.kind == "f" and size in _FLOAT:
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0, size,
                           0, 8 * size, *_FLOAT[size])
    raise TypeError(f"h5file writes integers of 1, 2, 4, 8 bytes and floats of 2, 4, "
                    f"8 bytes, not {dt}")


class Dataset:
    """A dataset; ``ds[()]`` reads all of it into a new array."""

    def __init__(self, file: "File", hdr: int, shape, dtype, addr: int,
                 compact: bytes | None = None):
        self._file, self._hdr = file, hdr
        self.shape = tuple(int(d) for d in shape)
        self.dtype = np.dtype(dtype)
        self._addr, self._compact = addr, compact

    def __getitem__(self, key):
        arr = np.empty(self.shape, self.dtype)
        if self._compact is not None:
            arr.reshape(-1).view(np.uint8)[:] = np.frombuffer(self._compact, np.uint8)
        elif arr.nbytes:
            self._file._read_into(arr.reshape(-1).view(np.uint8), self._addr)
        return arr if key is Ellipsis or (isinstance(key, tuple) and not key) else arr[key]


class Group:
    """A group: members by name, or by a path of names joined with '/'."""

    def __init__(self, file: "File", hdr: int | None, stab, parent: "Group | None"):
        self._file = file
        self._hdr = hdr  # object header address; None until first written
        self._stab = stab  # (B-tree address, local heap address) or None
        self._parent = parent
        self._members: dict | None = None  # name -> entry row or opened object
        self._dirty = hdr is None

    # --- lookup -------------------------------------------------------
    def _index(self) -> dict:
        if self._members is None:
            self._members = {} if self._stab is None else self._file._read_group(*self._stab)
        return self._members

    def _child(self, name: str):
        members = self._index()
        obj = members[name]
        if isinstance(obj, tuple):
            obj = members[name] = self._file._open(obj, self, name)
        return obj

    def _resolve(self, path: str, create: bool = False):
        """(parent group, last name) of `path`; with `create`, missing
        intermediate groups are created."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise KeyError(path)
        group = self
        for part in parts[:-1]:
            if create and part not in group._index():
                group = group._add_group(part)
                continue
            group = group._child(part)
            if not isinstance(group, Group):
                raise KeyError(f"{path}: {part} is not a group")
        return group, parts[-1]

    def __getitem__(self, path: str):
        group, name = self._resolve(path)
        return group._child(name)

    def __contains__(self, path: str) -> bool:
        try:
            group, name = self._resolve(path)
        except KeyError:
            return False
        return name in group._index()

    def keys(self) -> list:
        names = list(self._index())
        return sorted(names) if self._dirty else names

    def items(self):
        for name in self.keys():
            yield name, self._child(name)

    # --- changes ------------------------------------------------------
    def _touch(self):
        group = self
        while group is not None and not group._dirty:
            group._dirty = True
            group = group._parent

    def _add_group(self, name: str) -> "Group":
        self._file._check_writable()
        group = Group(self._file, None, None, self)
        self._index()[name] = group
        self._touch()
        return group

    def create_group(self, path: str) -> "Group":
        group, name = self._resolve(path, create=True)
        if name in group._index():
            raise ValueError(f"{path} already exists")
        return group._add_group(name)

    def create_dataset(self, path: str, data) -> Dataset:
        self._file._check_writable()
        group, name = self._resolve(path, create=True)
        if name in group._index():
            raise ValueError(f"{path} already exists")
        ds = self._file._write_dataset(np.asarray(data))
        group._index()[name] = ds
        group._touch()
        return ds

    def __delitem__(self, path: str):
        """Unlink; the object's bytes stay in the file."""
        self._file._check_writable()
        group, name = self._resolve(path)
        del group._index()[name]
        group._touch()


class File(Group):
    """An HDF5 file. `mode`: "r" read, "a" read and append (created if
    missing), "w" create or truncate."""

    def __init__(self, path: os.PathLike, mode: str = "r"):
        if mode not in ("r", "a", "w"):
            raise ValueError(f"mode must be 'r', 'a' or 'w', not {mode!r}")
        self.path = Path(path)
        self.mode = mode
        create = mode == "w" or (mode == "a" and not self.path.exists())
        flags = {"r": os.O_RDONLY, "a": os.O_RDWR, "w": os.O_RDWR}[mode]
        if create:
            flags |= os.O_CREAT | os.O_TRUNC
        self._fd = os.open(self.path, flags, 0o644)
        self._pending: list = []
        self._pending_at = 0  # file offset of the first pending byte
        try:
            if create:
                self._leaf_k, self._node_k, self._sb_pos = LEAF_K, NODE_K, 24
                self._eof = self._pending_at = 96  # the superblock's size
                self._pwrite(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                             + struct.pack("<HHI", LEAF_K, NODE_K, 0), 0)
                super().__init__(self, None, None, None)
                self.flush()
            else:
                self._read_superblock()
        except BaseException:
            os.close(self._fd)
            self._fd = None
            raise

    # --- raw access ---------------------------------------------------
    def _fail(self, what: str, addr: int | None = None) -> H5FileError:
        where = f" at byte {addr}" if addr is not None else ""
        return H5FileError(f"{self.path}: {what}{where}")

    def _read(self, addr: int, n: int) -> bytes:
        if self._pending and addr + n > self._pending_at:
            self._flush_pending()
        out = os.pread(self._fd, n, addr)
        if len(out) != n:
            raise self._fail(f"truncated file: {n} bytes wanted", addr)
        return out

    def _read_into(self, buf: np.ndarray, addr: int):
        if self._pending and addr + buf.nbytes > self._pending_at:
            self._flush_pending()
        view = memoryview(buf)
        while view.nbytes:
            n = os.preadv(self._fd, [view], addr)
            if n <= 0:
                raise self._fail("truncated file in a dataset", addr)
            view, addr = view[n:], addr + n

    def _pwrite(self, data, addr: int):
        view = memoryview(data).cast("B")
        while view.nbytes:
            n = os.pwrite(self._fd, view, addr)
            view, addr = view[n:], addr + n

    def _flush_pending(self):
        if self._pending:
            self._pwrite(b"".join(self._pending), self._pending_at)
            self._pending.clear()
        self._pending_at = self._eof

    def _append(self, data) -> int:
        """Append 8-aligned at the end of the file; returns the address."""
        addr = self._eof
        raw = memoryview(data).cast("B")
        pad = -raw.nbytes % 8
        self._eof += raw.nbytes + pad
        if raw.nbytes >= _LARGE:
            self._flush_pending()
            self._pwrite(raw, addr)
            if pad:
                self._pwrite(bytes(pad), addr + raw.nbytes)
            self._pending_at = self._eof
            return addr
        self._pending.append(bytes(raw) + bytes(pad))
        if self._eof - self._pending_at >= _PENDING_MAX:
            self._flush_pending()
        return addr

    def _check_writable(self):
        if self.mode == "r":
            raise OSError(f"{self.path}: opened read-only")

    # --- reading ------------------------------------------------------
    def _read_superblock(self):
        size = os.fstat(self._fd).st_size
        if size < 8 or os.pread(self._fd, 8, 0) != SIGNATURE:
            raise self._fail("not an HDF5 file (no signature at byte 0)")
        head = self._read(0, 24)
        version = head[8]
        if version not in (0, 1):
            raise self._fail(f"superblock version {version} is not supported", 8)
        if head[13] != 8 or head[14] != 8:
            raise self._fail(f"offsets of {head[13]} and lengths of {head[14]} bytes "
                             "are not supported", 13)
        self._leaf_k, self._node_k = struct.unpack_from("<HH", head, 16)
        self._sb_pos = pos = 24 + (4 if version == 1 else 0)
        base, _, eof, layout_info = struct.unpack("<4Q", self._read(pos, 32))
        if base != 0:
            raise self._fail("a base address other than 0 (user block) is not supported")
        if layout_info != UNDEF:  # a multi-file or family layout's info block
            raise self._fail("a file split over several files is not supported")
        if size < eof:
            raise self._fail(f"truncated file: {size} bytes, end of file at {eof}")
        self._eof = self._pending_at = eof
        root = np.frombuffer(self._read(pos + 32, 40), _ENTRY)[0]
        hdr = int(root["hdr"])
        stab = ((int(root["btree"]), int(root["heap"])) if root["cache"] == 1
                else self._object_stab(hdr))
        super().__init__(self, hdr, stab, None)

    def _messages(self, addr: int) -> list:
        """(type, data) of the messages that are read, from a version-1
        object header and its continuation chunks."""
        head = self._read(addr, 16)
        if head[:4] == b"OHDR":
            raise self._fail("version-2 object header is not supported", addr)
        version, _, _, _, size = struct.unpack_from("<BBHII", head)
        if version != 1:
            raise self._fail(f"object header version {version} is not supported", addr)
        chunks, out = [(addr + 16, size)], []
        while chunks:
            start, length = chunks.pop(0)
            buf, pos = self._read(start, length), 0
            while pos + 8 <= length:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
                if pos + 8 + msize > length:
                    raise self._fail("object header message overruns its chunk", start + pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == 0x10:
                    chunks.append(struct.unpack_from("<QQ", data))
                elif mtype in _READ_MSGS:
                    if flags & 0x02:
                        raise self._fail(f"shared message of type {mtype:#x} is not "
                                         "supported", start + pos)
                    out.append((mtype, data))
                elif mtype not in _SKIP_MSGS:
                    what = _MSG_NAMES.get(mtype, f"object header message type {mtype:#x}")
                    raise self._fail(f"{what} is not supported", addr)
        return out

    def _object_stab(self, addr: int):
        for mtype, data in self._messages(addr):
            if mtype == 0x11:
                return struct.unpack_from("<QQ", data)
        raise self._fail("object is not an old-style group", addr)

    def _open(self, entry: tuple, parent: Group, name: str):
        hdr, cache, btree, heap = entry
        if cache == 1:
            return Group(self, hdr, (btree, heap), parent)
        if cache != 0:
            raise self._fail(f"{name}: symbolic link (cache type {cache}) is not supported")
        msgs = dict(self._messages(hdr))
        if 0x11 in msgs:
            return Group(self, hdr, struct.unpack_from("<QQ", msgs[0x11]), parent)
        if 0x08 not in msgs or 0x01 not in msgs or 0x03 not in msgs:
            raise self._fail(f"{name}: object is neither a group nor a dataset", hdr)
        return self._dataset(hdr, msgs, name)

    def _dataset(self, hdr: int, msgs: dict, name: str) -> Dataset:
        space = msgs[0x01]
        version, rank, flags = space[0], space[1], space[2]
        if version == 1:
            pos, kind = 8, 1 if rank else 0
        elif version == 2:
            pos, kind = 4, space[3]
        else:
            raise self._fail(f"{name}: dataspace version {version} is not supported", hdr)
        if kind == 2:
            raise self._fail(f"{name}: null dataspace is not supported", hdr)
        shape = struct.unpack_from(f"<{rank}Q", space, pos) if kind == 1 else ()
        dtype = self._dtype(msgs[0x03], name, hdr)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        layout = msgs[0x08]
        if layout[0] not in (3, 4):
            raise self._fail(f"{name}: data layout version {layout[0]} is not supported", hdr)
        if layout[1] == 0:
            size = struct.unpack_from("<H", layout, 2)[0]
            if size != nbytes:
                raise self._fail(f"{name}: compact data of {size} bytes, {nbytes} expected", hdr)
            return Dataset(self, hdr, shape, dtype, UNDEF, bytes(layout[4:4 + size]))
        if layout[1] != 1:
            kind = {2: "chunked", 3: "virtual"}.get(layout[1], f"class {layout[1]}")
            raise self._fail(f"{name}: {kind} data layout is not supported", hdr)
        addr, size = struct.unpack_from("<QQ", layout, 2)
        if addr == UNDEF and nbytes:
            raise self._fail(f"{name}: dataset with no storage allocated", hdr)
        if addr != UNDEF and size != nbytes:
            raise self._fail(f"{name}: contiguous data of {size} bytes, {nbytes} expected", hdr)
        return Dataset(self, hdr, shape, dtype, addr)

    def _dtype(self, msg: bytes, name: str, hdr: int) -> np.dtype:
        cls, bits0, bits1 = msg[0] & 0x0F, msg[1], msg[2]
        size = struct.unpack_from("<I", msg, 4)[0]
        order = ">" if bits0 & 1 else "<"
        if cls == 0 and size in (1, 2, 4, 8) and not bits0 & 0x06:
            if struct.unpack_from("<HH", msg, 8) == (0, 8 * size):
                return np.dtype(f"{order}{'i' if bits0 & 0x08 else 'u'}{size}")
        if cls == 1 and size in _FLOAT and bits0 & 0xFE == 0x20 and bits1 == 8 * size - 1:
            if struct.unpack_from("<HHBBBBI", msg, 8) == (0, 8 * size, *_FLOAT[size]):
                return np.dtype(f"{order}f{size}")
        what = _TYPE_CLASSES[cls] if cls < len(_TYPE_CLASSES) else f"class {cls}"
        raise self._fail(f"{name}: {size}-byte {what} datatype is not supported", hdr)

    def _read_group(self, btree: int, heap: int) -> dict:
        """name -> (object header, cache type, B-tree, heap) of a group's
        members, in symbol-table order."""
        head = self._read(heap, 32)
        if head[:4] != b"HEAP" or head[4] != 0:
            raise self._fail("local heap expected", heap)
        data_size, _, data_addr = struct.unpack_from("<QQQ", head, 8)
        names = self._read(data_addr, data_size)
        rows, size = [], 8 + 80 * self._leaf_k
        for addr in self._btree_leaves(btree):
            node = self._read(addr, size)
            n = struct.unpack_from("<H", node, 6)[0]
            if node[:4] != b"SNOD" or n > 2 * self._leaf_k:
                raise self._fail("symbol-table node expected", addr)
            rows.append(node[8:8 + 40 * n])
        rows = np.frombuffer(b"".join(rows), _ENTRY)
        members = {}
        for off, hdr, cache, bt, hp in zip(rows["name"].tolist(), rows["hdr"].tolist(),
                                           rows["cache"].tolist(), rows["btree"].tolist(),
                                           rows["heap"].tolist()):
            end = names.find(b"\0", off)
            if end < 0:
                raise self._fail("link name runs past its local heap", data_addr + off)
            members[names[off:end].decode()] = (hdr, cache, bt, hp)
        return members

    def _btree_leaves(self, root: int) -> list:
        """Symbol-table node addresses of a group B-tree, in key order."""
        nodes = [root]
        while True:
            children, level = [], 0
            for addr in nodes:
                head = self._read(addr, 24)
                if head[:4] != b"TREE" or head[4] != 0:
                    raise self._fail("group B-tree node expected", addr)
                level, used = head[5], struct.unpack_from("<H", head, 6)[0]
                if used > 2 * self._node_k:
                    raise self._fail(f"B-tree node with {used} entries", addr)
                body = struct.unpack(f"<{2 * used + 1}Q", self._read(addr + 24, 16 * used + 8))
                children.extend(body[1::2])
            if level == 0:
                return children
            nodes = children

    # --- writing ------------------------------------------------------
    def _write_dataset(self, arr: np.ndarray) -> Dataset:
        dtype = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
        msg_type = _dtype_message(dtype)
        arr = np.ascontiguousarray(arr, dtype)
        addr = self._append(arr.reshape(-1).view(np.uint8)) if arr.nbytes else UNDEF
        dims = struct.pack(f"<{arr.ndim}Q", *arr.shape)
        space = struct.pack("<BBBB4x", 1, arr.ndim, 1, 0) + dims + dims
        layout = struct.pack("<BBQQ", 3, 1, addr, arr.nbytes)
        msgs = (_message(0x01, space) + _message(0x03, msg_type, 1)
                + _message(0x05, _FILL_MSG, 1) + _message(0x08, layout))
        hdr = self._append(_object_header(msgs))
        return Dataset(self, hdr, arr.shape, dtype, addr)

    def _write_group(self, group: Group):
        """Append `group`'s metadata (after that of its changed subgroups)."""
        members = group._index()
        for obj in members.values():
            if isinstance(obj, Group) and obj._dirty:
                self._write_group(obj)
        names = sorted(members)
        entries, offsets = [], []
        heap = bytearray(8)  # offset 0: the empty name, B-tree key 0
        for name in names:
            obj = members[name]
            if isinstance(obj, tuple):
                hdr, cache, btree, hp = obj
                if cache not in (0, 1):  # a soft link's value lives in this heap
                    raise self._fail(f"{name}: a group holding a symbolic link is not "
                                     "rewritten")
            elif isinstance(obj, Group):
                hdr, cache, (btree, hp) = obj._hdr, 1, obj._stab
            else:
                hdr, cache, btree, hp = obj._hdr, 0, 0, 0
            raw = name.encode()
            offsets.append(len(heap))
            entries.append(struct.pack("<QQIIQQ", len(heap), hdr, cache, 0, btree, hp))
            heap += raw + bytes(8 - len(raw) % 8)
        heap_addr = self._append(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap), _FREE_NULL,
                                             self._eof + 32) + heap)
        # Level 0: symbol-table nodes of up to 2 * leaf K entries, each keyed
        # by the heap offset of its last name.
        per = 2 * self._leaf_k
        children, keys = [], []
        for lo in range(0, len(names), per):
            part = entries[lo:lo + per]
            node = struct.pack("<4sBBH", b"SNOD", 1, 0, len(part)) + b"".join(part)
            children.append(self._append(node.ljust(8 + 40 * per, b"\0")))
            keys.append(offsets[lo + len(part) - 1])
        level = 0
        while True:  # one level of B-tree nodes of up to 2 * node K children
            fan = 2 * self._node_k
            count = max(1, -(-len(children) // fan))
            size = 24 + (2 * fan + 1) * 8
            first = self._eof
            up_children, up_keys = [], []
            for j in range(count):
                lo, hi = j * fan, min((j + 1) * fan, len(children))
                left = first + (j - 1) * size if j else UNDEF
                right = first + (j + 1) * size if j + 1 < count else UNDEF
                body = [keys[lo - 1] if lo else 0]
                for c, k in zip(children[lo:hi], keys[lo:hi]):
                    body += [c, k]
                node = struct.pack(f"<4sBBHQQ{len(body)}Q", b"TREE", 0, level, hi - lo,
                                   left, right, *body)
                up_children.append(self._append(node.ljust(size, b"\0")))
                up_keys.append(keys[hi - 1] if hi > lo else 0)
            if count == 1:
                btree = up_children[0]
                break
            children, keys, level = up_children, up_keys, level + 1
        stab = _message(0x11, struct.pack("<QQ", btree, heap_addr))
        group._hdr = self._append(_object_header(stab))
        group._stab = (btree, heap_addr)
        group._members = {name: members[name] for name in names}
        group._dirty = False

    def flush(self):
        """Write the changed groups, then point the superblock at them:
        its addresses (base, free space, end of file, layout info) and its
        root entry."""
        if self.mode == "r":
            return
        if self._dirty:
            self._write_group(self)
        self._flush_pending()
        root = np.zeros(1, _ENTRY)
        root[0] = (0, self._hdr, 1, 0, *self._stab)
        self._pwrite(struct.pack("<4Q", 0, UNDEF, self._eof, UNDEF) + root.tobytes(),
                     self._sb_pos)

    def close(self):
        if self._fd is None:
            return
        try:
            if self.mode != "r":
                self.flush()
                os.ftruncate(self._fd, self._eof)
        finally:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
