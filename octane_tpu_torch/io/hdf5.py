"""HDF5 / netCDF-4 reader and writer in numpy, ``zlib`` and ``struct``.

The port's files (GOES-R L1b, polar and mercator grids, CLAVR-x cloud-top
height, first-guess winds, products, sequence checkpoints and the
multi-process part files) go through this module, so the same code reads
and writes them wherever PyTorch runs.  It covers the part of the HDF5
file format (format specification 3.0) that those files use, with a small
mapping-like surface:

* ``File(path, "r")``: ``f[name]``, ``name in f``, ``f.keys()``,
  ``f.attrs``; a ``Dataset`` has ``shape``, ``dtype``, ``attrs``,
  ``ds[()]`` and ``ds[r0:r1]`` (a row slice reads only the chunks that hold
  those rows).  Attributes decode when read, so one of a type outside the
  subset (an object reference, a compound) fails only when it is asked for.
* ``File(path, "w")``: ``create_dataset(name, data=... | shape=...,
  dtype=...)``, ``ds[rows] = block``, ``attrs[k] = v``, ``make_scale`` and
  ``dims[i].attach_scale``.  It writes what the HDF5 library writes with its
  default file settings (superblock 0, version-1 object headers, a
  symbol-table root group): a ``str`` attribute as a variable-length UTF-8
  string, dimension scales as the HDF5 dimension-scale convention has them
  (CLASS, NAME, REFERENCE_LIST and DIMENSION_LIST), so netCDF-4 readers see
  shared dimensions.  Datasets are contiguous, or chunked (v1 B-tree) with
  shuffle and deflate when asked.

Read side: superblocks 0-3; object headers 1 and 2 with continuation
blocks; groups as symbol tables (v1 B-tree, SNOD, local heap) and as link
messages, compact or dense (fractal heap and v2 B-tree name index);
attributes compact (messages 1-3) or dense; fixed-point (1/2/4/8 bytes,
either byte order) and IEEE float (4/8 bytes) numbers, fixed-length and
variable-length (global heap) strings; scalar and simple dataspaces;
layout messages 3 (compact, contiguous, chunked with a v1 B-tree) and 4
(compact, contiguous, chunked with the single-chunk, implicit or
fixed-array index); the deflate, shuffle and fletcher32 filters with each
chunk's filter mask; fill values of chunks never written.  Anything else
raises ``HDF5Error`` naming what it met.  Checksums of version-2 metadata
are not verified; fletcher32 chunk checksums are.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

UNDEF = (1 << 64) - 1                  # the undefined address
_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32008: "bitshuffle", 32015: "zstd"}
_CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string",
                4: "bitfield", 5: "opaque", 6: "compound", 7: "reference", 8: "enum",
                9: "variable-length", 10: "array"}
# IEEE layouts: size -> (precision, exponent location, exponent size,
# mantissa location, mantissa size, exponent bias)
_IEEE = {4: (32, 23, 8, 0, 23, 127), 8: (64, 52, 11, 0, 52, 1023)}


class HDF5Error(ValueError):
    """The file is not HDF5, is damaged, or uses a part of the format
    outside this codec's subset (the message names it)."""


def File(path: str, mode: str = "r"):
    """Open ``path`` for reading (``"r"``) or create it, truncating any file
    there (``"w"``).  Use it as a context manager."""
    if mode == "r":
        return ReadFile(path)
    if mode == "w":
        return WriteFile(path)
    raise ValueError(f"mode must be 'r' or 'w', not {mode!r}")


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _enc_size(n: int) -> int:
    """Bytes needed to encode values up to ``n`` (H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


class _Cursor:
    """Little-endian field reader over a bytes object."""

    __slots__ = ("data", "pos", "so", "sl")

    def __init__(self, data: bytes, pos: int = 0, so: int = 8, sl: int = 8):
        self.data, self.pos, self.so, self.sl = data, pos, so, sl

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise HDF5Error("structure ends before its fields do (damaged file)")
        self.pos += n
        return b

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def u8(self) -> int:
        return self.uint(1)

    def u16(self) -> int:
        return self.uint(2)

    def u32(self) -> int:
        return self.uint(4)

    def u64(self) -> int:
        return self.uint(8)

    def addr(self) -> int:
        v = self.uint(self.so)
        return UNDEF if v == (1 << (8 * self.so)) - 1 else v

    def length(self) -> int:
        return self.uint(self.sl)

    def left(self) -> int:
        return len(self.data) - self.pos


# ---------------------------------------------------------------------------
# datatypes and dataspaces (shared by both sides)
# ---------------------------------------------------------------------------

class _Type:
    """A decoded datatype: ``kind`` is "num" (numpy ``dtype``), "fstr"
    (fixed-length string, numpy ``S`` dtype), "vstr" (variable-length
    string) or "other" (``what`` says which; reading its values raises)."""

    __slots__ = ("kind", "dtype", "size", "what")

    def __init__(self, kind, dtype, size, what=""):
        self.kind, self.dtype, self.size, self.what = kind, dtype, size, what


def _decode_type(data: bytes) -> _Type:
    c = _Cursor(data)
    cv = c.u8()
    cls, bits, size = cv & 0x0F, c.take(3), c.u32()
    name = _CLASS_NAMES.get(cls, f"class {cls}")
    if cls == 0:
        off, prec = c.u16(), c.u16()
        if off or prec != 8 * size or size not in (1, 2, 4, 8):
            return _Type("other", None, size, f"{prec}-bit {name} at bit {off}")
        order = ">" if bits[0] & 1 else "<"
        return _Type("num", np.dtype(f"{order}{'i' if bits[0] & 8 else 'u'}{size}"), size)
    if cls == 1:
        layout = (c.u16(), c.u16(), c.u8(), c.u8(), c.u8(), c.u8(), c.u32())
        if bits[0] & 0x40 or size not in _IEEE or layout != (0,) + _IEEE[size]:
            return _Type("other", None, size, f"non-IEEE {8 * size}-bit {name}")
        return _Type("num", np.dtype(f"{'>' if bits[0] & 1 else '<'}f{size}"), size)
    if cls == 3:
        return _Type("fstr", np.dtype(f"S{size}"), size)
    if cls == 9 and bits[0] & 0x0F == 1:
        return _Type("vstr", None, size)
    if cls == 9:
        return _Type("other", None, size, "variable-length sequence")
    return _Type("other", None, size, name)


def _decode_space(data: bytes, sl: int) -> Tuple[Optional[tuple], Optional[tuple]]:
    """(shape, max shape) of a dataspace message; shape None for a null
    dataspace, () for a scalar one."""
    c = _Cursor(data, sl=sl)
    ver, rank, flags = c.u8(), c.u8(), c.u8()
    if ver == 1:
        c.take(5)
        stype = 1 if rank else 0
    elif ver == 2:
        stype = c.u8()
    else:
        raise HDF5Error(f"dataspace message version {ver} is not supported")
    if stype == 2:
        return None, None
    dims = tuple(c.length() for _ in range(rank))
    maxdims = tuple(c.length() for _ in range(rank)) if flags & 1 else dims
    return dims, tuple(d if m == UNDEF or m < d else m for d, m in zip(dims, maxdims))


def _numeric_type_bytes(dt: np.dtype) -> bytes:
    """Datatype message (version 1) of a numpy integer or float dtype."""
    be = dt.byteorder == ">" or (dt.byteorder == "=" and not np.little_endian)
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        flags = (1 if be else 0) | (8 if dt.kind == "i" else 0)
        return struct.pack("<B3BIHH", 0x10, flags, 0, 0, dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in _IEEE:
        prec, eloc, esize, mloc, msize, bias = _IEEE[dt.itemsize]
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20 | (1 if be else 0), prec - 1, 0,
                           dt.itemsize, 0, prec, eloc, esize, mloc, msize, bias)
    raise TypeError(f"dtype {dt} is not a 1/2/4/8-byte integer or a 4/8-byte float")



def _fstr_type_bytes(size: int, pad: int) -> bytes:
    """Fixed-length ASCII string datatype; pad 0 null-terminated, 1 null-padded."""
    return struct.pack("<B3BI", 0x13, pad, 0, 0, size)


# variable-length UTF-8 string (base: unsigned char)
_VSTR_TYPE = struct.pack("<B3BI", 0x19, 0x01, 0x01, 0, 16) + struct.pack(
    "<B3BIHH", 0x10, 0, 0, 0, 1, 0, 8)
# variable-length sequence of object references (DIMENSION_LIST)
_REF_TYPE = struct.pack("<B3BI", 0x17, 0, 0, 0, 8)
_VREF_TYPE = struct.pack("<B3BI", 0x19, 0, 0, 0, 16) + _REF_TYPE
# compound {dataset: object reference, dimension: int32} (REFERENCE_LIST)
_REFLIST_TYPE = (
    struct.pack("<B3BI", 0x16, 2, 0, 0, 16)
    + b"dataset\0" + struct.pack("<IB3xI4x16x", 0, 0, 0) + _REF_TYPE
    + b"dimension\0\0\0\0\0\0\0" + struct.pack("<IB3xI4x16x", 8, 0, 0)
    + struct.pack("<B3BIHH", 0x10, 0x08, 0, 0, 4, 0, 32))


def _space_bytes(shape: tuple) -> bytes:
    """Dataspace message version 1 (rank 0 is a scalar), with the maximum
    dimensions equal to the dimensions."""
    dims = b"".join(struct.pack("<Q", n) for n in shape)
    return struct.pack("<BBB5x", 1, len(shape), 1 if shape else 0) + dims + dims


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def _fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32) of ``data``."""
    n = len(data)
    words = np.frombuffer(data[:n - n % 2], ">u2").astype(np.uint64)
    sum1 = sum2 = 0
    for s in range(0, len(words), 360):
        blk = words[s:s + 360]
        k = len(blk)
        tot = int(blk.sum())
        tri = int((blk * np.arange(k, 0, -1, dtype=np.uint64)).sum())
        sum2 = (sum2 + k * sum1 + tri) & 0xFFFFFFFF
        sum1 = (sum1 + tot) & 0xFFFFFFFF
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if n % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


def _shuffle(data: bytes, es: int) -> bytes:
    """The shuffle filter: byte k of every element into plane k (the bytes
    past the last whole element stay at the end)."""
    n = len(data) // es
    if es == 1 or n == 0:
        return data
    if es in (2, 4, 8):
        # whole-word shifts: a strided byte transpose is several times slower
        words = np.frombuffer(data, f"<u{es}", n)
        planes = np.empty((es, n), np.uint8)
        for k in range(es):
            planes[k] = words >> (8 * k)
        head = planes.tobytes()
    else:
        head = np.frombuffer(data, np.uint8, n * es).reshape(n, es).T.tobytes()
    return head + data[n * es:]


def _unshuffle(data: bytes, es: int) -> bytes:
    """The shuffle filter undone."""
    n = len(data) // es
    if es == 1 or n == 0:
        return data
    planes = np.frombuffer(data, np.uint8, n * es).reshape(es, n)
    if es in (2, 4, 8):
        words = planes[0].astype(f"<u{es}")
        for k in range(1, es):
            words |= planes[k].astype(words.dtype) << (8 * k)
        head = words.tobytes()
    else:
        head = planes.T.tobytes()
    return head + data[n * es:]


def _parse_filters(body: bytes) -> list:
    """[(filter id, client data)] of a filter pipeline message."""
    c = _Cursor(body)
    ver, n = c.u8(), c.u8()
    if ver == 1:
        c.take(6)
    elif ver != 2:
        raise HDF5Error(f"filter pipeline message version {ver} is not supported")
    out = []
    for _ in range(n):
        fid = c.u16()
        nlen = c.u16() if ver == 1 or fid >= 256 else 0
        c.u16()                                     # flags
        ncd = c.u16()
        c.take(_align8(nlen) if ver == 1 else nlen)
        cd = [c.u32() for _ in range(ncd)]
        if ver == 1 and ncd % 2:
            c.take(4)
        out.append((fid, cd))
    return out


def _check_filters(filters) -> None:
    for fid, _ in filters:
        if fid not in (1, 2, 3):
            name = _FILTER_NAMES.get(fid, "unregistered")
            raise HDF5Error(f"chunks use filter {fid} ({name}); this codec decodes "
                            "only deflate, shuffle and fletcher32")


def _unfilter(raw: bytes, filters, mask: int, es: int) -> bytes:
    for i in range(len(filters) - 1, -1, -1):
        if mask >> i & 1:
            continue
        fid, cd = filters[i]
        if fid == 1:
            raw = zlib.decompress(raw)
        elif fid == 2:
            raw = _unshuffle(raw, cd[0] if cd else es)
        elif fid == 3:
            body, stored = raw[:-4], raw[-4:]
            got = _fletcher32(body)
            if struct.pack("<I", got) != stored and struct.pack(">I", got) != stored:
                raise HDF5Error("a chunk fails its fletcher32 checksum (damaged file)")
            raw = body
    return raw


# ---------------------------------------------------------------------------
# read side
# ---------------------------------------------------------------------------

class _Message:
    """A header message; ``corder`` is its creation order where the header
    tracks that of its attributes, else None."""

    __slots__ = ("mtype", "flags", "body", "corder")

    def __init__(self, mtype, flags, body, corder=None):
        self.mtype, self.flags, self.body, self.corder = mtype, flags, body, corder


class _Reader:
    """The open file: byte ranges, the superblock's field sizes and caches
    of the structures already decoded."""

    def __init__(self, path: str):
        self.fh = open(path, "rb")
        try:
            self.size = os.fstat(self.fh.fileno()).st_size
            self.base, self.so, self.sl, self.root = self._superblock()
        except BaseException:
            self.fh.close()
            raise
        self._headers: Dict[int, List[_Message]] = {}
        self._gheaps: Dict[int, Dict[int, bytes]] = {}
        self._fheaps: Dict[int, "_FractalHeap"] = {}

    def read(self, addr: int, n: int, relative: bool = True) -> bytes:
        at = addr + self.base if relative else addr
        if addr == UNDEF or at + n > self.size:
            raise HDF5Error(f"a structure at {addr} runs past the end of the file "
                            f"({self.size} bytes): truncated or damaged")
        out = bytearray()
        while len(out) < n:
            got = os.pread(self.fh.fileno(), n - len(out), at + len(out))
            if not got:
                raise HDF5Error("short read")
            out += got
        return bytes(out)

    def read_into(self, addr: int, out: np.ndarray) -> None:
        """Fill the C-contiguous array ``out`` from the bytes at ``addr``."""
        view = memoryview(out).cast("B")
        if addr + self.base + len(view) > self.size:
            raise HDF5Error(f"data at {addr} runs past the end of the file")
        self.fh.seek(addr + self.base)
        done = 0
        while done < len(view):
            got = self.fh.readinto(view[done:])
            if not got:
                raise HDF5Error("short read")
            done += got

    def cursor(self, data: bytes, pos: int = 0) -> _Cursor:
        return _Cursor(data, pos, self.so, self.sl)

    def _superblock(self):
        at = 0
        while True:
            if at + 8 > self.size:
                raise HDF5Error("not an HDF5 file (no superblock signature)")
            if self.read(at, 8, relative=False) == _SIGNATURE:
                break
            at = 512 if at == 0 else 2 * at
        head = self.read(at, min(256, self.size - at), relative=False)
        ver = head[8]
        if ver in (0, 1):
            so, sl = head[13], head[14]
            c = _Cursor(head, 24 + (4 if ver == 1 else 0), so, sl)
            base = c.addr()
            c.addr(), c.addr(), c.addr()             # free space, EOF, driver
            c.addr()                                  # root link name offset
            root = c.addr()
        elif ver in (2, 3):
            so, sl = head[9], head[10]
            c = _Cursor(head, 12, so, sl)
            base = c.addr()
            c.addr(), c.addr()                        # extension, EOF
            root = c.addr()
        else:
            raise HDF5Error(f"superblock version {ver} is not supported")
        if so not in (2, 4, 8) or sl not in (2, 4, 8):
            raise HDF5Error(f"offset/length sizes {so}/{sl} are not supported")
        return (at if base == UNDEF else base), so, sl, root

    # -- object headers ----------------------------------------------------

    def messages(self, addr: int) -> List[_Message]:
        msgs = self._headers.get(addr)
        if msgs is None:
            msgs = self._headers[addr] = self._read_header(addr)
        return msgs

    def _read_header(self, addr: int) -> List[_Message]:
        head = self.read(addr, 16)
        out: List[_Message] = []
        if head[:4] == b"OHDR":
            c = self.cursor(self.read(addr, min(64, self.size - addr - self.base)), 4)
            ver, flags = c.u8(), c.u8()
            if ver != 2:
                raise HDF5Error(f"object header version {ver} is not supported")
            if flags & 0x20:
                c.take(16)
            if flags & 0x10:
                c.take(4)
            size0 = c.uint(1 << (flags & 3))
            start = c.pos
            chunk = self.read(addr, start + size0)
            pending = [(chunk, start, start + size0)]
            corder = bool(flags & 0x04)
            while pending:
                data, pos, end = pending.pop(0)
                pending += self._v2_messages(data, pos, end, corder, out)
            return out
        if head[0] != 1:
            raise HDF5Error(f"no object header at {addr} (version byte {head[0]})")
        c = self.cursor(head, 2)
        nmsg, _, size0 = c.u16(), c.u32(), c.u32()
        pending = [(addr + 16, size0)]
        while pending and len(out) < nmsg:
            at, size = pending.pop(0)
            c = self.cursor(self.read(at, size))
            while c.left() >= 8 and len(out) < nmsg:
                mtype, msize, mflags = c.u16(), c.u16(), c.u8()
                c.take(3)
                body = c.take(msize)
                if mtype == 0x10:
                    cc = self.cursor(body)
                    pending.append((cc.addr(), cc.length()))
                out.append(_Message(mtype, mflags, body))
        return out

    def _v2_messages(self, data, pos, end, corder, out):
        more = []
        hsize = 6 if corder else 4
        c = self.cursor(data, pos)
        while end - c.pos >= hsize:
            mtype, msize, mflags = c.u8(), c.u16(), c.u8()
            order = c.u16() if corder else None
            body = c.take(msize)
            if mtype == 0x10:
                cc = self.cursor(body)
                at, size = cc.addr(), cc.length()
                blk = self.read(at, size)
                if blk[:4] != b"OCHK":
                    raise HDF5Error(f"continuation block at {at} has no OCHK signature")
                more.append((blk, 4, size - 4))
            out.append(_Message(mtype, mflags, body, order))
        return more

    # -- heaps ---------------------------------------------------------------

    def local_heap(self, addr: int) -> bytes:
        c = self.cursor(self.read(addr, 8 + 2 * self.sl + self.so))
        if c.take(4) != b"HEAP":
            raise HDF5Error(f"no local heap at {addr}")
        c.take(4)
        size = c.length()
        c.length()
        return self.read(c.addr(), size)

    def global_object(self, addr: int, index: int) -> bytes:
        coll = self._gheaps.get(addr)
        if coll is None:
            c = self.cursor(self.read(addr, 8 + self.sl))
            if c.take(4) != b"GCOL":
                raise HDF5Error(f"no global heap collection at {addr}")
            c.take(4)
            size = c.length()
            data = self.read(addr, size)
            coll = {}
            c = self.cursor(data, 8 + self.sl)
            while c.left() >= 8 + self.sl:
                idx, _ = c.u16(), c.u16()
                c.take(4)
                n = c.length()
                if idx == 0:
                    break
                coll[idx] = data[c.pos:c.pos + n]
                c.pos += _align8(n)
            self._gheaps[addr] = coll
        try:
            return coll[index]
        except KeyError:
            raise HDF5Error(f"global heap object {index} at {addr} is missing") from None

    def fractal_heap(self, addr: int) -> "_FractalHeap":
        h = self._fheaps.get(addr)
        if h is None:
            h = self._fheaps[addr] = _FractalHeap(self, addr)
        return h

    # -- v2 B-trees ----------------------------------------------------------

    def btree2_records(self, addr: int) -> List[bytes]:
        c = self.cursor(self.read(addr, 16 + self.so + 2 + self.sl + 4))
        if c.take(4) != b"BTHD":
            raise HDF5Error(f"no v2 B-tree header at {addr}")
        c.u8()
        c.u8()                                       # type
        node_size, rec_size, depth = c.u32(), c.u16(), c.u16()
        c.take(2)
        root, nrec = c.addr(), c.u16()
        leaf_max = (node_size - 10) // rec_size
        nrec_size = _enc_size(leaf_max)
        cum, cum_size = [leaf_max], [0]
        for d in range(1, depth + 1):
            ptr = self.so + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            mx = (node_size - (10 + ptr)) // (rec_size + ptr)
            cum.append((mx + 1) * cum[d - 1] + mx)
            cum_size.append(_enc_size(cum[d]))
        out: List[bytes] = []
        if root == UNDEF:
            return out

        def walk(at, n, d):
            data = self.read(at, node_size)
            sig = data[:4]
            if sig != (b"BTLF" if d == 0 else b"BTIN"):
                raise HDF5Error(f"bad v2 B-tree node at {at}")
            recs = [data[6 + i * rec_size:6 + (i + 1) * rec_size] for i in range(n)]
            if d == 0:
                out.extend(recs)
                return
            c = self.cursor(data, 6 + n * rec_size)
            kids = []
            for _ in range(n + 1):
                kids.append((c.addr(), c.uint(nrec_size)))
                if d > 1:
                    c.uint(cum_size[d - 1])
            for i, (kat, kn) in enumerate(kids):
                walk(kat, kn, d - 1)
                if i < n:
                    out.append(recs[i])

        walk(root, nrec, depth)
        return out

    # -- v1 B-trees ----------------------------------------------------------

    def btree1_entries(self, addr: int, key_size: int) -> List[Tuple[bytes, int]]:
        """(left key, child) of every leaf entry of the v1 B-tree at ``addr``."""
        out: List[Tuple[bytes, int]] = []
        hsize = 8 + 2 * self.so

        def walk(at):
            head = self.read(at, hsize)
            if head[:4] != b"TREE":
                raise HDF5Error(f"bad v1 B-tree node at {at}")
            level, n = head[5], int.from_bytes(head[6:8], "little")
            body = self.read(at + hsize, n * (key_size + self.so) + key_size)
            c = self.cursor(body)
            for _ in range(n):
                key = c.take(key_size)
                child = c.addr()
                if level:
                    walk(child)
                else:
                    out.append((key, child))

        walk(addr)
        return out


class _FractalHeap:
    """A fractal heap's managed objects, found by heap ID."""

    def __init__(self, rd: _Reader, addr: int):
        self.rd = rd
        c = rd.cursor(rd.read(addr, min(256, rd.size - addr - rd.base)))
        if c.take(4) != b"FRHP":
            raise HDF5Error(f"no fractal heap at {addr}")
        c.u8()
        c.u16()                                      # heap ID length
        if c.u16():
            raise HDF5Error("fractal heaps with I/O filters are not supported")
        c.u8()
        max_managed = c.u32()
        c.length(), c.addr(), c.length(), c.addr()
        for _ in range(8):
            c.length()
        self.width = c.u16()
        self.start = c.length()
        self.max_direct = c.length()
        max_heap_bits = c.u16()
        c.u16()
        root = c.addr()
        rows = c.u16()
        self.off_size = (max_heap_bits + 7) // 8
        self.len_size = min((self.max_direct.bit_length() - 1 + 7) // 8,
                            _enc_size(max_managed))
        self.max_drows = (self.max_direct.bit_length() - self.start.bit_length()) + 2
        self.blocks: List[Tuple[int, int, int]] = []     # (heap offset, address, size)
        if root != UNDEF:
            if rows == 0:
                self._direct(root, self.start)
            else:
                self._indirect(root, rows)
        self.blocks.sort()

    def _row_size(self, r: int) -> int:
        return self.start if r == 0 else self.start << (r - 1)

    def _direct(self, at: int, size: int) -> None:
        c = self.rd.cursor(self.rd.read(at, 5 + self.rd.so + self.off_size))
        if c.take(4) != b"FHDB":
            raise HDF5Error(f"no fractal heap direct block at {at}")
        c.u8()
        c.addr()
        self.blocks.append((c.uint(self.off_size), at, size))

    def _indirect(self, at: int, nrows: int) -> None:
        so = self.rd.so
        nd = min(nrows, self.max_drows)
        n = nd * self.width + (nrows - nd) * self.width
        c = self.rd.cursor(self.rd.read(at, 5 + so + self.off_size + n * so))
        if c.take(4) != b"FHIB":
            raise HDF5Error(f"no fractal heap indirect block at {at}")
        c.u8()
        c.addr()
        c.uint(self.off_size)
        first_bits = self.start.bit_length() - 1 + self.width.bit_length() - 1
        for r in range(nrows):
            for _ in range(self.width):
                child = c.addr()
                if child == UNDEF:
                    continue
                size = self._row_size(r)
                if r < self.max_drows:
                    self._direct(child, size)
                else:
                    self._indirect(child, (size.bit_length() - 1) - first_bits + 1)

    def get(self, hid: bytes) -> bytes:
        kind = (hid[0] >> 4) & 3
        if kind == 2:
            return hid[1:1 + (hid[0] & 0x0F) + 1]
        if kind != 0:
            raise HDF5Error("huge fractal heap objects are not supported")
        c = _Cursor(hid, 1)
        off, n = c.uint(self.off_size), c.uint(self.len_size)
        for boff, at, size in self.blocks:
            if boff <= off < boff + size:
                return self.rd.read(at + off - boff, n)
        raise HDF5Error(f"fractal heap offset {off} lies in no direct block")


def _link_message(rd: _Reader, body: bytes):
    """(name, creation order or None, target address) of a link message."""
    c = rd.cursor(body)
    ver, flags = c.u8(), c.u8()
    if ver != 1:
        raise HDF5Error(f"link message version {ver} is not supported")
    ltype = c.u8() if flags & 0x08 else 0
    corder = c.u64() if flags & 0x04 else None
    if flags & 0x10:
        c.u8()
    name = c.take(c.uint(1 << (flags & 3))).decode("utf-8")
    if ltype != 0:
        kind = {1: "soft", 64: "external"}.get(ltype, f"type-{ltype}")
        return name, corder, HDF5Error(f"{name!r} is a {kind} link; only hard links "
                                       "are followed")
    return name, corder, c.addr()


def _links(rd: _Reader, addr: int) -> Dict[str, object]:
    """The links of the group whose object header is at ``addr``, in
    creation order where it is tracked, else in name order."""
    found = []
    for m in rd.messages(addr):
        if m.mtype == 0x11:                            # symbol table
            c = rd.cursor(m.body)
            btree, heap = c.addr(), c.addr()
            names = rd.local_heap(heap)
            for _, snod in rd.btree1_entries(btree, rd.sl):
                found += _snod_links(rd, snod, names)
        elif m.mtype == 0x06:
            found.append(_link_message(rd, m.body))
        elif m.mtype == 0x02:                          # link info
            c = rd.cursor(m.body)
            c.u8()
            flags = c.u8()
            if flags & 1:
                c.u64()
            fheap, names = c.addr(), c.addr()
            if fheap != UNDEF:
                heap = rd.fractal_heap(fheap)
                for rec in rd.btree2_records(names):
                    found.append(_link_message(rd, heap.get(rec[4:])))
    if found and all(co is not None for _, co, _ in found):
        found.sort(key=lambda t: t[1])
    else:
        found.sort(key=lambda t: t[0].encode())
    return {name: target for name, _, target in found}


def _snod_links(rd: _Reader, at: int, names: bytes):
    esize = 2 * rd.so + 24
    head = rd.read(at, 8)
    if head[:4] != b"SNOD":
        raise HDF5Error(f"no symbol table node at {at}")
    n = int.from_bytes(head[6:8], "little")
    c = rd.cursor(rd.read(at + 8, n * esize))
    out = []
    for _ in range(n):
        off, obj = c.uint(rd.so), c.addr()
        c.take(24)
        name = names[off:names.index(b"\0", off)].decode("utf-8")
        out.append((name, None, obj))
    return out


class _RawAttribute:
    """An attribute message's parts, decoded into a value when read."""

    def __init__(self, rd: _Reader, body: bytes, shared: bool = False):
        c = rd.cursor(body)
        ver = c.u8()
        if ver == 1:
            c.u8()
        elif ver in (2, 3):
            shared = shared or bool(c.u8() & 3)
        else:
            raise HDF5Error(f"attribute message version {ver} is not supported")
        nsize, tsize, ssize = c.u16(), c.u16(), c.u16()
        if ver == 3:
            c.u8()
        pad = _align8 if ver == 1 else (lambda n: n)
        self.name = c.take(pad(nsize)).split(b"\0")[0].decode("utf-8")
        self.rd, self.shared = rd, shared
        self.dtype_msg = c.take(pad(tsize))
        self.space_msg = c.take(pad(ssize))
        self.data = body[c.pos:]

    def value(self):
        if self.shared:
            raise HDF5Error(f"attribute {self.name!r} uses a shared datatype or "
                            "dataspace, which this codec does not read")
        t = _decode_type(self.dtype_msg)
        shape, _ = _decode_space(self.space_msg, self.rd.sl)
        if shape is None:
            return None
        n = int(np.prod(shape, dtype=np.int64))
        if t.kind in ("num", "fstr"):
            arr = np.frombuffer(self.data, t.dtype, n).reshape(shape).copy()
            return arr[()] if shape == () else arr
        if t.kind == "vstr":
            vals = [_vstr(self.rd, self.data[i * t.size:(i + 1) * t.size]) for i in range(n)]
            if shape == ():
                return vals[0]
            return np.array(vals, dtype=object).reshape(shape)
        raise HDF5Error(f"attribute {self.name!r} has a {t.what} datatype, which this "
                        "codec does not read")


def _vstr(rd: _Reader, elem: bytes) -> str:
    c = rd.cursor(elem)
    n, at, idx = c.u32(), c.addr(), c.u32()
    if n == 0:
        return ""
    return rd.global_object(at, idx)[:n].decode("utf-8", "replace")


class Attributes:
    """The attributes of an object read from a file: a read-only mapping
    whose values decode when read: a numpy scalar or array, ``np.bytes_``
    for a fixed-length string, ``str`` for a variable-length one."""

    def __init__(self, rd: _Reader, msgs: List[_Message]):
        self._rd, self._msgs, self._raw = rd, msgs, None

    def _load(self) -> Dict[str, _RawAttribute]:
        """Name -> attribute, in creation order where the header tracks it,
        else in name order (the HDF5 library's default order)."""
        if self._raw is None:
            found = []
            for m in self._msgs:
                if m.mtype == 0x0C:
                    found.append((_RawAttribute(self._rd, m.body, bool(m.flags & 2)),
                                  m.corder))
                elif m.mtype == 0x15:                    # attribute info
                    c = self._rd.cursor(m.body)
                    c.u8()
                    tracked = c.u8() & 1
                    if tracked:
                        c.u16()
                    fheap, names = c.addr(), c.addr()
                    if fheap == UNDEF:
                        continue
                    heap = self._rd.fractal_heap(fheap)
                    for rec in self._rd.btree2_records(names):
                        found.append((_RawAttribute(self._rd, heap.get(rec[:8]),
                                                    bool(rec[8] & 2)),
                                      int.from_bytes(rec[9:13], "little") if tracked
                                      else None))
            if found and all(order is not None for _, order in found):
                found.sort(key=lambda t: t[1])
            else:
                found.sort(key=lambda t: t[0].name.encode())
            self._raw = {a.name: a for a, _ in found}
        return self._raw

    def __getitem__(self, name: str):
        try:
            raw = self._load()[name]
        except KeyError:
            raise KeyError(f"no attribute {name!r}") from None
        return raw.value()

    def get(self, name: str, default=None):
        return self[name] if name in self else default

    def __contains__(self, name) -> bool:
        return name in self._load()

    def keys(self):
        return list(self._load())

    def __iter__(self):
        return iter(self.keys())


class Dataset:
    """A dataset of a file open for reading."""

    def __init__(self, rd: _Reader, name: str, addr: int):
        self._rd, self.name = rd, name
        msgs = rd.messages(addr)
        self.attrs = Attributes(rd, msgs)
        by = {}
        for m in msgs:
            by.setdefault(m.mtype, m)
        for need, what in ((0x01, "dataspace"), (0x03, "datatype"), (0x08, "layout")):
            if need not in by:
                raise HDF5Error(f"{name!r} is not a dataset (no {what} message)")
            if by[need].flags & 2:
                raise HDF5Error(f"{name!r} has a shared {what} message, which this codec "
                                "does not read")
        self._type = _decode_type(by[0x03].body)
        shape, self._maxshape = _decode_space(by[0x01].body, rd.sl)
        self.shape = () if shape is None else shape
        self._filters = _parse_filters(by[0x0B].body) if 0x0B in by else []
        self._fill_bytes = _fill_value(by.get(0x05) or by.get(0x04))
        self._layout(by[0x08].body)
        self._index = None

    @property
    def dtype(self) -> np.dtype:
        if self._type.kind not in ("num", "fstr"):
            raise HDF5Error(f"dataset {self.name!r} has a {self._type.what or 'variable-'
                            'length string'} datatype, which this codec does not read")
        return self._type.dtype

    def _layout(self, body: bytes) -> None:
        rd = self._rd
        c = rd.cursor(body)
        ver, cls = c.u8(), c.u8()
        if ver not in (3, 4):
            raise HDF5Error(f"layout message version {ver} of {self.name!r} is not "
                            "supported (only 3 and 4)")
        self._edge_unfiltered = False
        if cls == 0:
            self._kind, self._compact = "compact", c.take(c.u16())
        elif cls == 1:
            self._kind, self._addr = "contiguous", c.addr()
            c.length()
        elif cls == 2 and ver == 3:
            rank = c.u8()
            self._kind, self._index_kind, self._addr = "chunked", "btree1", c.addr()
            self._chunk = tuple(c.u32() for _ in range(rank))[:-1]
        elif cls == 2:
            flags, rank, enc = c.u8(), c.u8(), c.u8()
            self._chunk = tuple(c.uint(enc) for _ in range(rank))[:-1]
            self._edge_unfiltered = bool(flags & 1)
            itype = c.u8()
            self._single = None
            if itype == 1:
                self._index_kind = "single"
                if flags & 2:
                    self._single = (c.length(), c.u32())
            elif itype == 2:
                self._index_kind = "implicit"
            elif itype == 3:
                self._index_kind = "farray"
                c.u8()
            else:
                name = {4: "extensible array", 5: "v2 B-tree"}.get(itype, f"type {itype}")
                raise HDF5Error(f"{self.name!r} uses the {name} chunk index (a dataset "
                                "with an unlimited dimension); this codec reads the "
                                "single-chunk, implicit, fixed-array and v1 B-tree indexes")
            self._kind, self._addr = "chunked", c.addr()
        else:
            what = "virtual" if cls == 3 else f"class {cls}"
            raise HDF5Error(f"{self.name!r} has {what} storage, which is not supported")
        if self._kind == "chunked":
            _check_filters(self._filters)

    # -- chunk index ---------------------------------------------------------

    def _grid(self, shape) -> tuple:
        return tuple(-(-n // k) for n, k in zip(shape, self._chunk))

    def _chunk_index(self) -> Dict[tuple, Tuple[int, int, int]]:
        """{chunk grid position: (address, stored bytes, filter mask)}."""
        if self._index is not None:
            return self._index
        rd, idx = self._rd, {}
        nbytes = int(np.prod(self._chunk, dtype=np.int64)) * self._type.size
        if self._addr == UNDEF:
            pass
        elif self._index_kind == "btree1":
            rank = len(self._chunk)
            for key, child in rd.btree1_entries(self._addr, 8 + 8 * (rank + 1)):
                c = rd.cursor(key)
                size, mask = c.u32(), c.u32()
                offs = tuple(c.u64() for _ in range(rank))
                idx[tuple(o // k for o, k in zip(offs, self._chunk))] = (child, size, mask)
        elif self._index_kind == "single":
            size, mask = self._single or (nbytes, 0)
            idx[(0,) * len(self.shape)] = (self._addr, size, mask)
        else:
            grid = self._grid(self._maxshape)
            if self._index_kind == "implicit":
                entries = [(self._addr + i * nbytes, nbytes, 0)
                           for i in range(int(np.prod(grid, dtype=np.int64)))]
            else:
                entries = self._farray_entries(nbytes)
            for i, e in enumerate(entries):
                if e[0] != UNDEF:
                    idx[tuple(int(v) for v in np.unravel_index(i, grid))] = e
        self._index = idx
        return idx

    def _farray_entries(self, nbytes: int) -> list:
        rd, so = self._rd, self._rd.so
        c = rd.cursor(rd.read(self._addr, 12 + rd.sl + so))
        if c.take(4) != b"FAHD":
            raise HDF5Error(f"no fixed-array header for {self.name!r}")
        c.u8()
        client, esize, page_bits = c.u8(), c.u8(), c.u8()
        n, dblk = c.length(), c.addr()
        if dblk == UNDEF:
            return []
        page = 1 << page_bits
        npages = -(-n // page) if n > page else 0
        prefix = 6 + so

        def decode(buf, count):
            cc = rd.cursor(buf)
            out = []
            for _ in range(count):
                at = cc.addr()
                if client == 1:
                    size, mask = cc.uint(esize - so - 4), cc.u32()
                else:
                    size, mask = nbytes, 0
                out.append((at, size, mask))
            return out

        if not npages:
            return decode(rd.read(dblk + prefix, n * esize), n)
        bitmap = rd.read(dblk + prefix, (npages + 7) // 8)
        at = dblk + prefix + len(bitmap) + 4
        out = []
        for p in range(npages):
            cnt = min(page, n - p * page)
            if bitmap[p // 8] & (0x80 >> (p % 8)):
                out += decode(rd.read(at, cnt * esize), cnt)
            else:
                out += [(UNDEF, 0, 0)] * cnt
            at += page * esize + 4
        return out

    def _read_chunk(self, pos: tuple) -> np.ndarray:
        entry = self._chunk_index().get(pos)
        if entry is None:
            return self._filled(self._chunk)
        at, size, mask = entry
        raw = self._rd.read(at, size)
        edge = any((p + 1) * k > n for p, k, n in zip(pos, self._chunk, self.shape))
        if self._filters and not (self._edge_unfiltered and edge):
            raw = _unfilter(raw, self._filters, mask, self._type.size)
        n = int(np.prod(self._chunk, dtype=np.int64))
        if len(raw) < n * self._type.size:
            raise HDF5Error(f"a chunk of {self.name!r} decodes to {len(raw)} bytes, "
                            f"not {n * self._type.size}")
        return np.frombuffer(raw, self.dtype, n).reshape(self._chunk)

    def _filled(self, shape) -> np.ndarray:
        out = np.empty(shape, self.dtype)
        if self._fill_bytes and len(self._fill_bytes) == self._type.size:
            out[...] = np.frombuffer(self._fill_bytes, self.dtype, 1)[0]
        else:
            out[...] = np.zeros((), self.dtype)
        return out

    # -- reads ---------------------------------------------------------------

    def read_rows(self, r0: int, r1: int) -> np.ndarray:
        """Rows [r0, r1) of the dataset (its first axis) as a new array."""
        dt, tail = self.dtype, self.shape[1:]
        out = np.empty((r1 - r0,) + tail, dt)
        if r1 <= r0 or out.size == 0:
            return out
        rowbytes = int(np.prod(tail, dtype=np.int64)) * dt.itemsize
        if self._kind == "compact":
            out[...] = np.frombuffer(self._compact, dt, out.size,
                                     r0 * rowbytes).reshape(out.shape)
        elif self._kind == "contiguous":
            if self._addr == UNDEF:
                out[...] = self._filled(out.shape)
            else:
                self._rd.read_into(self._addr + r0 * rowbytes, out)
        else:
            k0 = self._chunk[0]
            grid = self._grid(self.shape)
            for p0 in range(r0 // k0, (r1 - 1) // k0 + 1):
                a, b = max(r0, p0 * k0), min(r1, (p0 + 1) * k0)
                for rest in np.ndindex(*grid[1:]):
                    blk = self._read_chunk((p0,) + tuple(rest))
                    dst = [slice(a - r0, b - r0)]
                    src = [slice(a - p0 * k0, b - p0 * k0)]
                    for q, k, n in zip(rest, self._chunk[1:], tail):
                        e = min(n, (q + 1) * k)
                        dst.append(slice(q * k, e))
                        src.append(slice(0, e - q * k))
                    out[tuple(dst)] = blk[tuple(src)]
        return out

    def __getitem__(self, key):
        if not self.shape:
            if key not in ((), Ellipsis):
                raise IndexError("a scalar dataset is read with ds[()]")
            if self._kind == "contiguous" and self._addr != UNDEF:
                out = np.empty((), self.dtype)
                self._rd.read_into(self._addr, out.reshape(1))
                return out[()]
            if self._kind == "compact":
                return np.frombuffer(self._compact, self.dtype, 1)[0]
            return self._filled(())[()]
        rest = ()
        if isinstance(key, tuple) and key and isinstance(key[0], slice):
            key, rest = key[0], key[1:]
        if key in ((), Ellipsis):
            return self.read_rows(0, self.shape[0])
        if isinstance(key, slice) and key.step in (None, 1):
            r0, r1, _ = key.indices(self.shape[0])
            out = self.read_rows(r0, max(r0, r1))
            return out[(slice(None),) + rest] if rest else out
        if isinstance(key, (int, np.integer)):
            r = int(key) + (self.shape[0] if key < 0 else 0)
            if not 0 <= r < self.shape[0]:
                raise IndexError(f"row {key} is outside {self.shape[0]} rows")
            return self.read_rows(r, r + 1)[0]
        whole = self.read_rows(0, self.shape[0])
        return whole[(key,) + rest] if rest else whole[key]


def _fill_value(msg: Optional[_Message]) -> Optional[bytes]:
    if msg is None:
        return None
    c = _Cursor(msg.body)
    if msg.mtype == 0x04:
        return c.take(c.u32())
    ver = c.u8()
    if ver in (1, 2):
        c.take(2)
        defined = c.u8()
        if ver == 1 or defined:
            return c.take(c.u32())
        return None
    if ver == 3:
        flags = c.u8()
        return c.take(c.u32()) if flags & 0x20 else None
    raise HDF5Error(f"fill value message version {ver} is not supported")


class ReadFile:
    """An HDF5 file open for reading: the datasets of its root group, by
    name (the port's files keep every variable there)."""

    def __init__(self, path: str):
        self.filename = path
        self._rd = _Reader(path)
        try:
            self.attrs = Attributes(self._rd, self._rd.messages(self._rd.root))
        except BaseException:
            self._rd.fh.close()
            raise
        self._links = None

    def _members(self) -> Dict[str, object]:
        if self._links is None:
            self._links = _links(self._rd, self._rd.root)
        return self._links

    def keys(self):
        return list(self._members())

    def __iter__(self):
        return iter(self.keys())

    def __contains__(self, name) -> bool:
        return name.strip("/") in self._members()

    def __getitem__(self, name: str) -> Dataset:
        key = name.strip("/")
        target = self._members().get(key)
        if target is None:
            raise KeyError(f"no dataset {name!r} in the root group")
        if isinstance(target, HDF5Error):
            raise target
        return Dataset(self._rd, "/" + key, target)

    def close(self) -> None:
        self._rd.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# write side
# ---------------------------------------------------------------------------

_SB_SIZE = 96                   # superblock 0 with 8-byte offsets and lengths
_LEAF_K, _GROUP_K, _CHUNK_K = 4, 16, 32


class _FixedStr(bytes):
    """A fixed-length string attribute; ``pad`` 0 null-terminated (the
    dimension-scale attributes), 1 null-padded (numpy ``S`` values)."""

    pad = 1


class _NullTermStr(_FixedStr):
    pad = 0


class _DimList:
    """The DIMENSION_LIST of a dataset: per axis, the scales attached."""

    def __init__(self, rank: int):
        self.scales: List[List["WriteDataset"]] = [[] for _ in range(rank)]


class _RefList:
    """The REFERENCE_LIST of a scale: (dataset, axis) per attachment."""

    def __init__(self):
        self.entries: List[Tuple["WriteDataset", int]] = []


class WriteAttributes:
    """Attributes of an object being written: ``attrs[k] = v`` with a
    ``str`` (variable-length UTF-8), ``bytes`` / ``np.bytes_`` (fixed
    length), a number or a numeric numpy array."""

    def __init__(self):
        self._items: Dict[str, object] = {}

    def __setitem__(self, name: str, value) -> None:
        self._items.pop(name, None)
        self._items[name] = _attr_value(value)

    def _put(self, name: str, value) -> None:
        self._items.pop(name, None)
        self._items[name] = value

    def __getitem__(self, name: str):
        return self._items[name]

    def __contains__(self, name) -> bool:
        return name in self._items

    def get(self, name, default=None):
        return self._items.get(name, default)

    def items(self):
        return list(self._items.items())


def _attr_value(v):
    if isinstance(v, str):
        return v
    if isinstance(v, (bytes, np.bytes_)):
        return _FixedStr(bytes(v))
    arr = np.asarray(v)
    if arr.dtype.kind in "iuf" and arr.dtype.itemsize in ((1, 2, 4, 8) if arr.dtype.kind
                                                           != "f" else (4, 8)):
        return arr.copy()
    raise TypeError(f"attribute values are str, bytes, or 1/2/4/8-byte integer and "
                    f"4/8-byte float numbers and arrays, not {arr.dtype}")


class _Dim:
    def __init__(self, ds: "WriteDataset", axis: int):
        self._ds, self._axis = ds, axis

    def attach_scale(self, scale: "WriteDataset") -> None:
        """Attach the dimension scale ``scale`` to this axis (HDF5's
        H5DSattach_scale: DIMENSION_LIST here, REFERENCE_LIST on ``scale``)."""
        ds = self._ds
        if scale is ds:
            raise ValueError("a dataset cannot be its own dimension scale")
        if "DIMENSION_LIST" not in ds.attrs:
            ds.attrs._put("DIMENSION_LIST", _DimList(len(ds.shape)))
        dl = ds.attrs["DIMENSION_LIST"]
        if scale in dl.scales[self._axis]:
            return
        dl.scales[self._axis].append(scale)
        rl = scale.attrs.get("REFERENCE_LIST") or _RefList()
        rl.entries.append((ds, self._axis))
        scale.attrs._put("REFERENCE_LIST", rl)


class WriteDataset:
    """A dataset of a file being written."""

    def __init__(self, f: "WriteFile", name: str, shape: tuple, dtype: np.dtype):
        self._f, self.name = f, "/" + name
        self.shape, self.dtype = tuple(int(n) for n in shape), dtype
        self.attrs = WriteAttributes()
        self.dims = [_Dim(self, i) for i in range(len(self.shape))]
        self._addr = UNDEF
        self._chunk = None
        self._chunks: List[Tuple[tuple, int, int]] = []
        self._filters: List[Tuple[int, int, List[int], bytes]] = []

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def make_scale(self, name: str = "") -> None:
        """Make this dataset a dimension scale (H5DSset_scale)."""
        self.attrs._put("CLASS", _NullTermStr(b"DIMENSION_SCALE"))
        if name:
            self.attrs._put("NAME", _NullTermStr(name.encode()))

    def __setitem__(self, key, value) -> None:
        if self._chunk is not None:
            raise TypeError("a chunked dataset is written whole, at create_dataset")
        if not self.shape:
            r0, r1 = 0, 1
        elif key in ((), Ellipsis):
            r0, r1 = 0, self.shape[0]
        elif isinstance(key, slice) and key.step in (None, 1):
            r0, r1, _ = key.indices(self.shape[0])
        else:
            raise TypeError("datasets are written by row slice (ds[r0:r1] = block)")
        block = np.ascontiguousarray(np.broadcast_to(
            np.asarray(value, self.dtype), (max(0, r1 - r0),) + self.shape[1:]))
        rowbytes = int(np.prod(self.shape[1:], dtype=np.int64)) * self.dtype.itemsize
        if block.size:
            self._f._write_at(self._addr + r0 * rowbytes, block)


class WriteFile:
    """An HDF5 file being written; the data go to disk as they arrive and
    the metadata when the file closes."""

    def __init__(self, path: str):
        self.filename = path
        self._fh = open(path, "wb")
        self._end = _SB_SIZE
        self._datasets: Dict[str, WriteDataset] = {}
        self.attrs = WriteAttributes()
        self.name = "/"

    # -- data ----------------------------------------------------------------

    def _alloc(self, n: int) -> int:
        at = self._end
        self._end = _align8(self._end + n)
        return at

    def _write_at(self, at: int, data) -> None:
        self._fh.seek(at)
        self._fh.write(memoryview(data).cast("B") if isinstance(data, np.ndarray) else data)

    def create_dataset(self, name: str, data=None, *, shape=None, dtype=None, chunks=None,
                       compression=None, compression_opts=None,
                       shuffle=False) -> WriteDataset:
        """A dataset in the root group, from ``data`` or of ``shape`` and
        ``dtype`` (then written by row slices).  ``chunks`` (with
        ``compression="gzip"`` and its level, and ``shuffle``) stores it
        chunked; it then needs ``data``."""
        name = name.strip("/")
        if not name or "/" in name:
            raise ValueError(f"datasets go in the root group: {name!r}")
        if name in self._datasets:
            raise ValueError(f"dataset {name!r} exists")
        if data is not None:
            arr = np.asarray(data, dtype)
            shape, dt = arr.shape, arr.dtype
        else:
            if shape is None or dtype is None:
                raise ValueError("create_dataset needs data, or shape and dtype")
            dt = np.dtype(dtype)
        _numeric_type_bytes(dt)
        ds = WriteDataset(self, name, shape, dt)
        if chunks is None:
            if compression or shuffle:
                raise ValueError("filters need chunks")
            if ds.nbytes:
                ds._addr = self._alloc(ds.nbytes)
                if data is not None:
                    self._write_at(ds._addr, np.ascontiguousarray(arr))
        else:
            if data is None:
                raise ValueError("a chunked dataset is written from data")
            if compression not in (None, "gzip"):
                raise ValueError(f"compression {compression!r}: only 'gzip' is written")
            self._write_chunked(ds, np.asarray(arr), tuple(int(k) for k in chunks),
                                compression_opts if compression else None, shuffle)
        self._datasets[name] = ds
        return ds

    def _write_chunked(self, ds, arr, chunk, level, shuffle) -> None:
        if len(chunk) != arr.ndim or min(chunk, default=1) < 1:
            raise ValueError(f"chunks {chunk} do not fit shape {arr.shape}")
        es = arr.dtype.itemsize
        if shuffle:
            ds._filters.append((2, 1, [es], b"shuffle\0"))
        if level is not None:
            ds._filters.append((1, 1, [int(level)], b"deflate\0"))
        ds._chunk = chunk
        grid = tuple(-(-n // k) for n, k in zip(arr.shape, chunk))
        for pos in np.ndindex(*grid):
            src = tuple(slice(p * k, min(n, (p + 1) * k))
                        for p, k, n in zip(pos, chunk, arr.shape))
            blk = np.zeros(chunk, arr.dtype)
            blk[tuple(slice(0, s.stop - s.start) for s in src)] = arr[src]
            raw = blk.tobytes()
            if shuffle:
                raw = _shuffle(raw, es)
            if level is not None:
                raw = zlib.compress(raw, int(level))
            at = self._alloc(len(raw))
            self._write_at(at, raw)
            ds._chunks.append((tuple(p * k for p, k in zip(pos, chunk)), at, len(raw)))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self._fh.close()

    # -- metadata ------------------------------------------------------------

    def close(self) -> None:
        """Write the metadata and the superblock, and close the file."""
        if self._fh.closed:
            return
        try:
            self._write_metadata()
        finally:
            self._fh.close()

    def _write_metadata(self) -> None:
        datasets = list(self._datasets.values())
        names = sorted(self._datasets, key=lambda s: s.encode())
        # layout: the object headers, the global heap, the root group's
        # local heap, symbol nodes and B-tree, then the chunk B-trees
        sizes = {id(d): len(self._header(d, _Addresses())) for d in datasets}
        root_size = len(self._root_header(_Addresses()))
        addrs = _Addresses()
        addrs.root = self._alloc(root_size)
        for d in datasets:
            addrs.obj[id(d)] = self._alloc(sizes[id(d)])
        gheap = _GlobalHeap()
        for d in datasets:
            self._header(d, addrs, gheap)
        self._root_header(addrs, gheap)
        addrs.gcol = self._alloc(gheap.size()) if gheap.objects else UNDEF
        heap_data = bytearray(8)
        name_off = {}
        for n in names:
            name_off[n] = len(heap_data)
            heap_data += n.encode() + b"\0"
            heap_data += b"\0" * (_align8(len(heap_data)) - len(heap_data))
        heap_data += b"\0" * max(0, 16 - len(heap_data))
        addrs.heap = self._alloc(32 + len(heap_data))
        self._write_at(addrs.heap, b"HEAP\0\0\0\0" + struct.pack(
            "<QQQ", len(heap_data), 1, addrs.heap + 32) + bytes(heap_data))
        # symbol nodes, 2 * leaf K entries each, in name order
        snods, keys = [], [0]
        per = 2 * _LEAF_K
        for s in range(0, max(len(names), 1), per):
            part = names[s:s + per]
            body = b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + b"".join(
                struct.pack("<QQII16x", name_off[n], addrs.obj[id(self._datasets[n])], 0, 0)
                for n in part)
            at = self._alloc(8 + per * 40)
            self._write_at(at, body.ljust(8 + per * 40, b"\0"))
            snods.append(at)
            keys.append(name_off[part[-1]] if part else 0)
        addrs.btree = self._btree1(0, snods, [struct.pack("<Q", k) for k in keys],
                                   2 * _GROUP_K, 8)
        for d in datasets:
            if d._chunk is not None:
                addrs.chunk_tree[id(d)] = self._chunk_btree(d)
        # final encodings
        gheap = _GlobalHeap()
        for d in datasets:
            hdr = self._header(d, addrs, gheap)
            if len(hdr) != sizes[id(d)]:
                raise RuntimeError(f"object header of {d.name!r} changed size")
            self._write_at(addrs.obj[id(d)], hdr)
        self._write_at(addrs.root, self._root_header(addrs, gheap))
        if gheap.objects:
            self._write_at(addrs.gcol, gheap.encode())
        eof = self._end
        self._fh.truncate(eof)
        sb = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", _LEAF_K, _GROUP_K, 0)
              + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
              + struct.pack("<QQII", 0, addrs.root, 1, 0)
              + struct.pack("<QQ", addrs.btree, addrs.heap))
        self._write_at(0, sb)

    def _btree1(self, ntype: int, children: List[int], keys: List[bytes], two_k: int,
                key_size: int) -> int:
        """Write a v1 B-tree over ``children`` (with the len + 1 boundary
        ``keys``) and return its root's address."""
        node_size = 8 + 16 + (two_k + 1) * key_size + two_k * 8
        level = 0
        while True:
            runs = [(s, min(s + two_k, len(children))) for s in range(0, len(children), two_k)]
            ats = [self._alloc(node_size) for _ in runs]
            for j, (a, b) in enumerate(runs):
                left = ats[j - 1] if j else UNDEF
                right = ats[j + 1] if j + 1 < len(ats) else UNDEF
                body = b"TREE" + struct.pack("<BBHQQ", ntype, level, b - a, left, right)
                for i in range(a, b):
                    body += keys[i] + struct.pack("<Q", children[i])
                body += keys[b]
                self._write_at(ats[j], body.ljust(node_size, b"\0"))
            if len(runs) == 1:
                return ats[0]
            keys = [keys[a] for a, _ in runs] + [keys[runs[-1][1]]]
            children, level = ats, level + 1

    def _chunk_btree(self, d: WriteDataset) -> int:
        def key(size, offs):
            return struct.pack("<II", size, 0) + b"".join(
                struct.pack("<Q", o) for o in offs + (0,))

        keys = [key(size, offs) for offs, _, size in d._chunks]
        last = d._chunks[-1][0]
        keys.append(struct.pack("<II", 0, 0) + b"".join(
            struct.pack("<Q", o + k) for o, k in zip(last, d._chunk))
            + struct.pack("<Q", d.dtype.itemsize))
        return self._btree1(1, [at for _, at, _ in d._chunks], keys, 2 * _CHUNK_K,
                            8 + 8 * (len(d.shape) + 1))

    def _root_header(self, addrs: "_Addresses", gheap=None) -> bytes:
        msgs = [(0x11, 0, struct.pack("<QQ", addrs.btree, addrs.heap))]
        msgs += self._attr_messages(self.attrs, addrs, gheap or _GlobalHeap())
        return _v1_header(msgs)

    def _header(self, d: WriteDataset, addrs: "_Addresses", gheap=None) -> bytes:
        msgs = [(0x01, 0, _space_bytes(d.shape)),
                (0x03, 1, _numeric_type_bytes(d.dtype)),
                (0x05, 1, struct.pack("<BBBBI", 2, 2 if d._chunk is None else 3, 2, 1, 0))]
        if d._chunk is None:
            layout = struct.pack("<BBQQ", 3, 1, d._addr, d.nbytes)
        else:
            layout = struct.pack("<BBBQ", 3, 2, len(d._chunk) + 1,
                                 addrs.chunk_tree.get(id(d), UNDEF)) + b"".join(
                struct.pack("<I", k) for k in d._chunk + (d.dtype.itemsize,))
        msgs.append((0x08, 0, layout))
        if d._filters:
            body = struct.pack("<BB6x", 1, len(d._filters))
            for fid, flags, cd, fname in d._filters:
                body += struct.pack("<HHHH", fid, _align8(len(fname)), flags, len(cd))
                body += fname.ljust(_align8(len(fname)), b"\0")
                body += b"".join(struct.pack("<I", v) for v in cd)
                if len(cd) % 2:
                    body += b"\0" * 4
            msgs.append((0x0B, 1, body))
        msgs += self._attr_messages(d.attrs, addrs, gheap or _GlobalHeap())
        return _v1_header(msgs)

    def _attr_messages(self, attrs: WriteAttributes, addrs: "_Addresses",
                       gheap: "_GlobalHeap") -> list:
        out = []
        for name, v in attrs.items():
            if isinstance(v, str):
                raw = v.encode("utf-8")
                tbytes, shape = _VSTR_TYPE, ()
                data = struct.pack("<IQI", len(raw), addrs.gcol, gheap.add(raw))
            elif isinstance(v, _FixedStr):
                size = len(v) + (1 if v.pad == 0 else 0)
                tbytes, shape = _fstr_type_bytes(max(size, 1), v.pad), ()
                data = bytes(v).ljust(max(size, 1), b"\0")
            elif isinstance(v, _DimList):
                tbytes, shape, data = _VREF_TYPE, (len(v.scales),), b""
                for scales in v.scales:
                    refs = b"".join(struct.pack("<Q", addrs.obj.get(id(s), 0)) for s in scales)
                    idx = gheap.add(refs) if refs else 0
                    data += struct.pack("<IQI", len(scales), addrs.gcol if refs else 0, idx)
            elif isinstance(v, _RefList):
                tbytes, shape = _REFLIST_TYPE, (len(v.entries),)
                data = b"".join(struct.pack("<Qi4x", addrs.obj.get(id(ds), 0), axis)
                                for ds, axis in v.entries)
            else:
                tbytes, shape = _numeric_type_bytes(v.dtype), v.shape
                data = np.ascontiguousarray(v).tobytes()
            sbytes = _space_bytes(shape)
            nb = name.encode("utf-8") + b"\0"
            body = (struct.pack("<BBHHH", 1, 0, len(nb), len(tbytes), len(sbytes))
                    + nb.ljust(_align8(len(nb)), b"\0")
                    + tbytes.ljust(_align8(len(tbytes)), b"\0")
                    + sbytes.ljust(_align8(len(sbytes)), b"\0") + data)
            if len(body) > 65535:
                raise ValueError(f"attribute {name!r} is too large for an object header")
            out.append((0x0C, 0, body))
        return out


class _Addresses:
    """Where the metadata go (0 while sizes are measured)."""

    def __init__(self):
        self.root = self.btree = self.heap = self.gcol = 0
        self.obj: Dict[int, int] = {}
        self.chunk_tree: Dict[int, int] = {}


class _GlobalHeap:
    """One global heap collection of the variable-length values."""

    def __init__(self):
        self.objects: List[bytes] = []

    def add(self, data: bytes) -> int:
        self.objects.append(data)
        return len(self.objects)

    def _used(self) -> int:
        return 16 + sum(16 + _align8(len(o)) for o in self.objects)

    def size(self) -> int:
        return max(4096, self._used() + 16)

    def encode(self) -> bytes:
        size = self.size()
        out = bytearray(b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size))
        for i, o in enumerate(self.objects, 1):
            out += struct.pack("<HH4xQ", i, 0, len(o)) + o.ljust(_align8(len(o)), b"\0")
        out += struct.pack("<HH4xQ", 0, 0, size - len(out))
        return bytes(out.ljust(size, b"\0"))


def _v1_header(msgs) -> bytes:
    """A version-1 object header holding ``msgs`` [(type, flags, body)]."""
    body = b"".join(struct.pack("<HHB3x", t, _align8(len(b)), fl) + b.ljust(_align8(len(b)),
                                                                             b"\0")
                    for t, fl, b in msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body
