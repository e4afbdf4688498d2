"""HDF5 datasets without h5py: a reader for the files that h5py writes by
default, and a writer of the same plain shape.

``read_datasets(path, names)`` reads the datasets ``names`` (paths from the
root group, "a/b/c" for nested groups) into numpy arrays in native byte
order. It takes:

* superblock version 0/1 (object header v1, symbol-table groups: a v1
  group B-tree of "SNOD" nodes, names in a local heap) and version 2/3
  (object header v1 or v2, groups of compact link messages);
* the dataspace, datatype, fill-value, filter-pipeline and data-layout
  messages, with header continuation blocks;
* fixed-point (1, 2, 4, 8 bytes, either byte order, signed or not) and
  IEEE floating-point (2, 4, 8 bytes, either byte order) elements;
* data layout version 3 (and 4 where it is encoded as 3): compact,
  contiguous, and chunked through a v1 chunk B-tree, with the deflate and
  shuffle filters.

Anything else (dense link storage in a fractal heap, the chunk indexes of
layout version 4, other filters, shared messages, compound, string and
variable-length types, soft or external links) raises a
``NotImplementedError`` that names it. Checksums are not verified.

``write_datasets(path, {name: array})`` writes a file of root-level
datasets as h5py does by default: superblock 0, a symbol-table root group,
contiguous layout, no filters.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
# IEEE 754 binary16/32/64 by size: (sign bit, exponent location, exponent
# size, mantissa size, exponent bias); the mantissa starts at bit 0
_IEEE = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127), 8: (63, 52, 11, 52, 1023)}


def _undefined(addr: int, size: int) -> bool:
    return addr == (1 << (8 * size)) - 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.base = self._superblock()

    # ------------------------------------------------------------ primitives
    def uint(self, off: int, size: int) -> int:
        return int.from_bytes(self.data[off:off + size], "little")

    def addr(self, off: int) -> int:
        return self.uint(off, self.so)

    def length(self, off: int) -> int:
        return self.uint(off, self.sl)

    def _superblock(self) -> int:
        start = 0
        while start < len(self.data):
            if self.data[start:start + 8] == SIGNATURE:
                break
            start = 512 if start == 0 else 2 * start
        else:
            raise ValueError("not an HDF5 file (no superblock signature)")
        off = start + 8
        version = self.data[off]
        if version in (0, 1):
            self.so, self.sl = self.data[off + 5], self.data[off + 6]
            p = off + 16 + (4 if version == 1 else 0)
            base = self.uint(p, self.so)
            # four addresses (the base first), then the root group's symbol
            # table entry (name offset, object header address)
            self.root = self.uint(p + 5 * self.so, self.so)
        elif version in (2, 3):
            self.so, self.sl = self.data[off + 1], self.data[off + 2]
            p = off + 4
            base = self.uint(p, self.so)
            self.root = self.uint(p + 3 * self.so, self.so)
        else:
            raise NotImplementedError(f"HDF5 superblock version {version}")
        return base

    # ---------------------------------------------------------- object header
    def messages(self, addr: int):
        """The (type, flags, body offset, body size) of every message of the
        object header at ``addr``, continuation blocks followed."""
        a = self.base + addr
        if self.data[a:a + 4] == b"OHDR":
            return self._messages_v2(a)
        if self.data[a] != 1:
            raise NotImplementedError(f"HDF5 object header version {self.data[a]}")
        out, blocks = [], [(a + 16, self.uint(a + 8, 4))]
        while blocks:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end:
                mtype, msize, mflags = self.uint(p, 2), self.uint(p + 2, 2), self.data[p + 4]
                body = p + 8
                if mtype == 0x10:
                    blocks.append((self.base + self.addr(body), self.length(body + self.so)))
                else:
                    out.append((mtype, mflags, body, msize))
                p = body + msize
        return out

    def _messages_v2(self, a: int):
        version, flags = self.data[a + 4], self.data[a + 5]
        if version != 2:
            raise NotImplementedError(f"HDF5 object header version {version}")
        p = a + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        nsize = 1 << (flags & 3)
        size = self.uint(p, nsize)
        p += nsize
        blocks, out = [(p, p + size)], []
        order = 2 if flags & 0x04 else 0
        while blocks:
            p, end = blocks.pop(0)
            while p + 4 + order <= end:
                mtype, msize, mflags = self.data[p], self.uint(p + 1, 2), self.data[p + 3]
                body = p + 4 + order
                if mtype == 0x10:
                    cont = self.base + self.addr(body)
                    if self.data[cont:cont + 4] != b"OCHK":
                        raise ValueError("HDF5 continuation block without OCHK signature")
                    blocks.append((cont + 4, cont + self.length(body + self.so) - 4))
                elif mtype != 0:
                    out.append((mtype, mflags, body, msize))
                p = body + msize
        return out

    # ----------------------------------------------------------------- groups
    def _local_heap(self, addr: int) -> int:
        a = self.base + addr
        if self.data[a:a + 4] != b"HEAP":
            raise ValueError("HDF5 local heap without HEAP signature")
        return self.base + self.addr(a + 8 + 2 * self.sl)

    def _cstring(self, off: int) -> str:
        return self.data[off:self.data.index(b"\0", off)].decode()

    def _symbol_table(self, btree: int, heap: int) -> Dict[str, int]:
        """name -> object header address of a v1 group B-tree's children."""
        names = self._local_heap(heap)
        out = {}
        stack = [btree]
        while stack:
            a = self.base + stack.pop()
            sig = self.data[a:a + 4]
            if sig == b"TREE":
                ntype, level, used = self.data[a + 4], self.data[a + 5], self.uint(a + 6, 2)
                if ntype != 0:
                    raise ValueError("HDF5 group B-tree node of another type")
                p = a + 8 + 2 * self.so + self.sl  # siblings, key 0
                for _ in range(used):
                    stack.append(self.addr(p))
                    p += self.so + self.sl
            elif sig == b"SNOD":
                for i in range(self.uint(a + 6, 2)):
                    e = a + 8 + i * (2 * self.so + 24)
                    soft = self.uint(e + 2 * self.so, 4) == 2  # cache type 2: a soft link
                    out[self._cstring(names + self.addr(e))] = (
                        None if soft else self.addr(e + self.so))
            else:
                raise ValueError(f"HDF5 group node with signature {sig!r}")
        return out

    def children(self, addr: int) -> Dict[str, int]:
        """name -> object header address of the group at ``addr`` (None for
        a link other than a hard link)."""
        out = {}
        for mtype, _, body, _ in self.messages(addr):
            if mtype == 0x11:  # symbol table
                out.update(self._symbol_table(self.addr(body), self.addr(body + self.so)))
            elif mtype == 0x02:  # link info
                flags = self.data[body + 1]
                heap = self.addr(body + 2 + (8 if flags & 1 else 0))
                if not _undefined(heap, self.so):
                    raise NotImplementedError(
                        "HDF5 dense link storage (fractal heap) is not supported")
            elif mtype == 0x06:  # link
                name, target = self._link(body)
                out[name] = target
        return out

    def _link(self, p: int) -> Tuple[str, Optional[int]]:
        flags = self.data[p + 1]
        p += 2
        ltype = 0
        if flags & 0x08:
            ltype = self.data[p]
            p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        nsize = 1 << (flags & 3)
        n = self.uint(p, nsize)
        p += nsize
        return self.data[p:p + n].decode(), None if ltype else self.addr(p + n)

    def find(self, name: str) -> int:
        addr = self.root
        for part in [x for x in name.split("/") if x]:
            kids = self.children(addr)
            if part not in kids:
                raise KeyError(f"no object {name!r} in the HDF5 file")
            addr = kids[part]
            if addr is None:
                raise NotImplementedError(
                    f"HDF5 soft or external link {part!r} (only hard links)")
        return addr

    # --------------------------------------------------------------- datasets
    def _dataspace(self, p: int) -> Tuple[int, ...]:
        version, rank = self.data[p], self.data[p + 1]
        if version == 1:
            q = p + 8
        elif version == 2:
            if self.data[p + 3] == 2:
                raise NotImplementedError("HDF5 null dataspace")
            q = p + 4
        else:
            raise NotImplementedError(f"HDF5 dataspace message version {version}")
        return tuple(self.length(q + i * self.sl) for i in range(rank))

    def _datatype(self, p: int) -> np.dtype:
        cls, bits, size = self.data[p] & 0x0F, self.uint(p + 1, 3), self.uint(p + 4, 4)
        order = ">" if bits & 1 else "<"
        offset, precision = self.uint(p + 8, 2), self.uint(p + 10, 2)
        if cls == 0:
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                raise NotImplementedError(
                    f"HDF5 fixed-point type of {size} bytes, precision {precision}")
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:
            fields = ((bits >> 8) & 0xFF, self.data[p + 12], self.data[p + 13],
                      self.data[p + 15], self.uint(p + 16, 4))
            if (bits & 0x40 or fields != _IEEE.get(size) or offset or self.data[p + 14]
                    or precision != 8 * size):
                raise NotImplementedError(f"HDF5 floating-point type of {size} bytes that "
                                          "is not IEEE 754 binary16/32/64")
            return np.dtype(f"{order}f{size}")
        names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
        raise NotImplementedError(f"HDF5 {names.get(cls, cls)} datatype")

    def _fill(self, p: int, version: int):
        """The fill value's bytes, or None where none is defined."""
        if version in (1, 2):
            defined = self.data[p + 3]
            if version == 1 or defined:
                size = self.uint(p + 4, 4)
                return self.data[p + 8:p + 8 + size] if size else None
            return None
        if version == 3:
            flags = self.data[p + 1]
            if flags & 0x20:
                size = self.uint(p + 2, 4)
                return self.data[p + 6:p + 6 + size]
            return None
        raise NotImplementedError(f"HDF5 fill value message version {version}")

    def _filters(self, p: int):
        version, n = self.data[p], self.data[p + 1]
        q = p + (8 if version == 1 else 2)
        out = []
        for _ in range(n):
            fid = self.uint(q, 2)
            named = version == 1 or fid >= 256
            nlen = self.uint(q + 2, 2) if named else 0
            q += 4 if named else 2
            nvals = self.uint(q + 2, 2)
            q += 4
            if version == 1:
                q += -(-nlen // 8) * 8
            else:
                q += nlen
            vals = [self.uint(q + 4 * i, 4) for i in range(nvals)]
            q += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2):
                known = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset"}
                raise NotImplementedError(
                    f"HDF5 filter {known.get(fid, fid)} (only deflate and shuffle)")
            out.append((fid, vals))
        return out

    def dataset(self, addr: int) -> np.ndarray:
        shape = dtype = layout = fill = None
        filters = []
        for mtype, mflags, body, _ in self.messages(addr):
            if mflags & 0x02 and mtype in (0x01, 0x03, 0x05, 0x0B):
                raise NotImplementedError(f"HDF5 shared message of type {mtype:#x}")
            if mtype == 0x01:
                shape = self._dataspace(body)
            elif mtype == 0x03:
                dtype = self._datatype(body)
            elif mtype == 0x05:
                fill = self._fill(body, self.data[body])
            elif mtype == 0x04 and fill is None:
                size = self.uint(body, 4)
                fill = self.data[body + 4:body + 4 + size] if size else None
            elif mtype == 0x0B:
                filters = self._filters(body)
            elif mtype == 0x08:
                layout = body
        if shape is None or dtype is None or layout is None:
            raise ValueError("not an HDF5 dataset (no dataspace, datatype or layout)")
        n = math.prod(shape)
        if fill is not None and len(fill) != dtype.itemsize:
            raise ValueError("HDF5 fill value of another size than the elements")
        fill_arr = np.frombuffer(fill, dtype) if fill is not None else np.zeros(1, dtype)

        version, cls = self.data[layout], self.data[layout + 1]
        if version not in (3, 4):
            raise NotImplementedError(f"HDF5 data layout message version {version}")
        if cls in (0, 1):
            if cls == 0:
                size, a = self.uint(layout + 2, 2), layout + 4
            else:
                a, size = self.addr(layout + 2), self.length(layout + 2 + self.so)
                a = None if _undefined(a, self.so) else self.base + a
            if a is None:
                out = np.full(n, fill_arr[0], dtype)
            elif size < n * dtype.itemsize or a + size > len(self.data):
                raise ValueError("HDF5 dataset storage shorter than its dataspace")
            else:
                out = np.frombuffer(self.data, dtype, count=n, offset=a)
        elif cls == 2:
            if version == 4:
                raise NotImplementedError(
                    "HDF5 chunk indexes of data layout version 4 (libver='latest')")
            out = self._chunked(layout, shape, dtype, filters, fill_arr)
        else:
            raise NotImplementedError(f"HDF5 data layout class {cls}")
        return out.reshape(shape).astype(dtype.newbyteorder("="))

    def _chunked(self, p, shape, dtype, filters, fill_arr) -> np.ndarray:
        ndims = self.data[p + 2]
        btree = self.addr(p + 3)
        q = p + 3 + self.so
        dims = [self.uint(q + 4 * i, 4) for i in range(ndims)]
        chunk, esize = tuple(dims[:-1]), dims[-1]
        if esize != dtype.itemsize or len(chunk) != len(shape):
            raise ValueError("HDF5 chunk dimensions do not match the dataset")
        out = np.full(shape, fill_arr[0], dtype)
        if _undefined(btree, self.so):
            return out
        stack = [btree]
        key = 8 + 8 * ndims
        while stack:
            a = self.base + stack.pop()
            if self.data[a:a + 4] != b"TREE" or self.data[a + 4] != 1:
                raise ValueError("HDF5 chunk B-tree node expected")
            level, used = self.data[a + 5], self.uint(a + 6, 2)
            k = a + 8 + 2 * self.so
            for _ in range(used):
                child = self.addr(k + key)
                if level > 0:
                    stack.append(child)
                else:
                    size, mask = self.uint(k, 4), self.uint(k + 4, 4)
                    origin = [self.uint(k + 8 + 8 * i, 8) for i in range(len(shape))]
                    raw = self.data[self.base + child:self.base + child + size]
                    for i in reversed(range(len(filters))):
                        if not mask & (1 << i):
                            raw = _unfilter(raw, *filters[i])
                    block = np.frombuffer(raw, dtype, count=math.prod(chunk)).reshape(chunk)
                    dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(origin, chunk, shape))
                    out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
                k += key + self.so
        return out


def _unfilter(raw: bytes, fid: int, vals) -> bytes:
    if fid == 1:
        return zlib.decompress(raw)
    esize = vals[0]
    n = len(raw) // esize
    body = np.frombuffer(raw, np.uint8, count=n * esize).reshape(esize, n).T
    return body.tobytes() + raw[n * esize:]


def read_datasets(path: str, names: Iterable[str]) -> Dict[str, np.ndarray]:
    """{name: array} of the datasets ``names`` of the HDF5 file ``path``."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    return {name: r.dataset(r.find(name)) for name in names}


# ------------------------------------------------------------------ writer
def _dtype_message(dt: np.dtype) -> bytes:
    order = 1 if dt.byteorder == ">" or (dt.byteorder == "=" and not np.little_endian) else 0
    if dt.kind in "iu":
        head = bytes([0x10, order | (0x08 if dt.kind == "i" else 0), 0, 0])
        return head + struct.pack("<IHH", dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in _IEEE:
        sign, exp_loc, exp_size, mant, bias = _IEEE[dt.itemsize]
        head = bytes([0x11, order | 0x20, sign, 0])
        return head + struct.pack("<IHHBBBBI", dt.itemsize, 0, 8 * dt.itemsize, exp_loc,
                                  exp_size, 0, mant, bias)
    raise ValueError(f"write_datasets takes integer and float arrays, not {dt}")


def _message(mtype: int, body: bytes) -> bytes:
    body = body + bytes(-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _object_header(msgs: bytes, n: int) -> bytes:
    return struct.pack("<BBHII4x", 1, 0, n, 1, len(msgs)) + msgs


def _dataset_header(a: np.ndarray, data_at: int) -> bytes:
    space = struct.pack("<BBBB4x", 1, a.ndim, 0, 0) + b"".join(
        struct.pack("<Q", d) for d in a.shape)
    fill = bytes([2, 2, 2, 0])  # version 2, late allocation, write if set, undefined
    layout = bytes([3, 1]) + struct.pack("<QQ", data_at, a.nbytes)  # v3 contiguous
    msgs = (_message(0x01, space) + _message(0x03, _dtype_message(a.dtype))
            + _message(0x05, fill) + _message(0x08, layout))
    return _object_header(msgs, 4)


def write_datasets(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """A file of root-level datasets ``arrays`` in h5py's default shape:
    superblock 0, 8-byte offsets and lengths, a symbol-table root group
    (one B-tree node, one symbol node, names in a local heap), object
    header v1, contiguous layout, no filters."""
    undef = b"\xff" * 8
    names = sorted(arrays)  # a symbol node keeps its names in order
    if not names or len(names) > 8 or any("/" in n or not n for n in names):
        raise ValueError("write_datasets takes 1 to 8 root-level dataset names")
    arrs = [np.ascontiguousarray(arrays[n]) for n in names]
    heap_data = bytearray(8)  # offset 0: the empty name
    name_off = []
    for n in names:
        name_off.append(len(heap_data))
        b = n.encode() + b"\0"
        heap_data += b + bytes(-len(b) % 8)

    sb_size, root_size = 96, 16 + 24
    btree_at = sb_size + root_size
    heap_at = btree_at + 8 + 16 + 33 * 8 + 32 * 8  # a group B-tree node of K = 16
    heap_data_at = heap_at + 32
    snod_at = heap_data_at + len(heap_data)
    at = snod_at + 8 + 8 * 40  # a symbol node of leaf K = 4
    header_at, data_at = [], []
    for a in arrs:
        header_at.append(at)
        at += len(_dataset_header(a, 0))
    for a in arrs:
        data_at.append(at)
        at += a.nbytes

    out = bytearray(at)
    out[0:56] = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack("<HHI", 4, 16, 0)
                 + struct.pack("<Q", 0) + undef + struct.pack("<Q", at) + undef)
    # the root group's symbol table entry, its B-tree and heap cached
    out[56:96] = struct.pack("<QQII", 0, sb_size, 1, 0) + struct.pack("<QQ", btree_at, heap_at)
    root = _object_header(_message(0x11, struct.pack("<QQ", btree_at, heap_at)), 1)
    out[sb_size:sb_size + len(root)] = root
    out[btree_at:btree_at + 48] = (b"TREE" + bytes([0, 0]) + struct.pack("<H", 1) + undef
                                   + undef + struct.pack("<QQQ", 0, snod_at, name_off[-1]))
    # no free block: the library's null offset is 1
    out[heap_at:heap_at + 32] = b"HEAP" + bytes(4) + struct.pack(
        "<QQQ", len(heap_data), 1, heap_data_at)
    out[heap_data_at:heap_data_at + len(heap_data)] = heap_data
    entries = b"".join(struct.pack("<QQII16x", off, h, 0, 0)
                       for off, h in zip(name_off, header_at))
    out[snod_at:snod_at + 8 + len(entries)] = (b"SNOD" + bytes([1, 0])
                                               + struct.pack("<H", len(names)) + entries)
    for a, h_at, d_at in zip(arrs, header_at, data_at):
        hdr = _dataset_header(a, d_at)
        out[h_at:h_at + len(hdr)] = hdr
        out[d_at:d_at + a.nbytes] = a.tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))
