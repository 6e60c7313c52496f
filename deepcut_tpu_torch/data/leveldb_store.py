"""Pure-Python LevelDB store (read path + minimal writer).

The reference's DB abstraction supports LMDB *and* LevelDB
(src/caffe/util/db.cpp:9-20, db_leveldb.cpp); this image has neither
libleveldb nor a Python binding, so — like lmdb_store.py — we implement the
on-disk format directly from its public specification (LevelDB
doc/log_format.md and doc/table_format.md):

- **Log files** (``NNNNNN.log``, also the MANIFEST container): 32 KiB blocks
  of [masked-crc32c, length, type] records, fragmented FULL/FIRST/MIDDLE/LAST;
  payloads are WriteBatch blobs (seq, count, tagged key/value ops).
- **Sorted tables** (``NNNNNN.ldb``/``.sst``): prefix-compressed blocks with
  restart arrays, a block index, and a fixed 48-byte footer ending in the
  table magic. Keys are InternalKeys (user_key + 8-byte seq|type suffix).
- **MANIFEST / CURRENT**: VersionEdit records naming the live tables and the
  active log; CURRENT points at the manifest.

Reader: merges all live tables and logs, newest sequence number wins,
deletions hide older values — the same view leveldb::DB::NewIterator gives
Caffe's LevelDBCursor. Writer: a bulk builder emitting either a log-only DB
(what a fresh leveldb::DB produces before compaction) or a single level-0
table, both openable by real LevelDB.

Compressed blocks (snappy/zstd) are rejected with a clear error — Caffe's
convert_imageset-era DBs are snappy-compressed only when libsnappy was linked
in; this pure-Python path supports uncompressed tables.

The port's own copy of `deepcut_tpu.data.leveldb_store` (jax-free; held against the
original by tests/test_torch_data_layers.py).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

BLOCK_SIZE = 32768            # log block
HEADER_SIZE = 7               # crc(4) + length(2) + type(1)
FULL, FIRST, MIDDLE, LAST = 1, 2, 3, 4

TYPE_DELETION, TYPE_VALUE = 0, 1
TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_SIZE = 48
MASK_DELTA = 0xA282EAD8

# VersionEdit tags (leveldb version_edit.cc)
TAG_COMPARATOR = 1
TAG_LOG_NUMBER = 2
TAG_NEXT_FILE = 3
TAG_LAST_SEQ = 4
TAG_COMPACT_POINTER = 5
TAG_DELETED_FILE = 6
TAG_NEW_FILE = 7
TAG_PREV_LOG = 9


# -- crc32c (Castagnoli), table-driven ---------------------------------------

_CRC_TABLE: List[int] = []


def _crc_init() -> None:
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_crc_init()


def crc32c(data: bytes, crc: int = 0) -> int:
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + MASK_DELTA) & 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    rot = (masked - MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# -- varints -----------------------------------------------------------------


def put_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def get_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _put_len_prefixed(out: bytearray, s: bytes) -> None:
    put_varint(out, len(s))
    out += s


def _get_len_prefixed(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = get_varint(buf, pos)
    return buf[pos:pos + n], pos + n


# -- log format --------------------------------------------------------------


class LogWriter:
    def __init__(self):
        self.chunks: List[bytes] = []
        self.block_offset = 0

    def add_record(self, payload: bytes) -> None:
        left = payload
        begin = True
        while True:
            leftover = BLOCK_SIZE - self.block_offset
            if leftover < HEADER_SIZE:
                self.chunks.append(b"\x00" * leftover)
                self.block_offset = 0
                leftover = BLOCK_SIZE
            avail = leftover - HEADER_SIZE
            frag, left = left[:avail], left[avail:]
            end = not left
            rtype = FULL if (begin and end) else FIRST if begin else LAST if end else MIDDLE
            crc = mask_crc(crc32c(bytes([rtype]) + frag))
            self.chunks.append(struct.pack("<IHB", crc, len(frag), rtype) + frag)
            self.block_offset += HEADER_SIZE + len(frag)
            begin = False
            if end:
                return

    def data(self) -> bytes:
        return b"".join(self.chunks)


def read_log_records(buf: bytes, *, verify: bool = True) -> Iterator[bytes]:
    """Yield logical records from a log-format file (reassembling fragments)."""
    pos = 0
    partial = b""
    while pos + HEADER_SIZE <= len(buf):
        block_left = BLOCK_SIZE - (pos % BLOCK_SIZE)
        if block_left < HEADER_SIZE:
            pos += block_left
            continue
        crc, length, rtype = struct.unpack_from("<IHB", buf, pos)
        if rtype == 0 and length == 0 and crc == 0:  # trailer padding
            pos += block_left
            continue
        frag = buf[pos + HEADER_SIZE: pos + HEADER_SIZE + length]
        if len(frag) < length:
            return  # truncated tail
        if verify and unmask_crc(crc) != crc32c(bytes([rtype]) + frag):
            raise ValueError(f"log record crc mismatch at offset {pos}")
        pos += HEADER_SIZE + length
        if rtype == FULL:
            yield frag
            partial = b""
        elif rtype == FIRST:
            partial = frag
        elif rtype == MIDDLE:
            partial += frag
        elif rtype == LAST:
            yield partial + frag
            partial = b""
        else:
            raise ValueError(f"bad log record type {rtype}")


# -- WriteBatch --------------------------------------------------------------


def encode_batch(seq: int, ops: List[Tuple[int, bytes, bytes]]) -> bytes:
    """ops: (type, key, value) with value ignored for deletions."""
    out = bytearray(struct.pack("<QI", seq, len(ops)))
    for t, k, v in ops:
        out.append(t)
        _put_len_prefixed(out, k)
        if t == TYPE_VALUE:
            _put_len_prefixed(out, v)
    return bytes(out)


def decode_batch(payload: bytes) -> Iterator[Tuple[int, int, bytes, bytes]]:
    """Yield (seq, type, key, value) per op."""
    seq, count = struct.unpack_from("<QI", payload)
    pos = 12
    for i in range(count):
        t = payload[pos]
        pos += 1
        key, pos = _get_len_prefixed(payload, pos)
        value = b""
        if t == TYPE_VALUE:
            value, pos = _get_len_prefixed(payload, pos)
        yield seq + i, t, key, value


# -- sorted tables -----------------------------------------------------------


def internal_key(user_key: bytes, seq: int, rtype: int = TYPE_VALUE) -> bytes:
    return user_key + struct.pack("<Q", (seq << 8) | rtype)


def split_internal_key(ikey: bytes) -> Tuple[bytes, int, int]:
    tag = struct.unpack("<Q", ikey[-8:])[0]
    return ikey[:-8], tag >> 8, tag & 0xFF


class _BlockBuilder:
    def __init__(self, restart_interval: int = 16):
        self.buf = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.last_key = b""
        self.interval = restart_interval

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.counter < self.interval:
            m = min(len(self.last_key), len(key))
            while shared < m and self.last_key[shared] == key[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.counter = 0
        put_varint(self.buf, shared)
        put_varint(self.buf, len(key) - shared)
        put_varint(self.buf, len(value))
        self.buf += key[shared:]
        self.buf += value
        self.last_key = key
        self.counter += 1

    def finish(self) -> bytes:
        out = bytes(self.buf)
        out += b"".join(struct.pack("<I", r) for r in self.restarts)
        out += struct.pack("<I", len(self.restarts))
        return out

    def size_estimate(self) -> int:
        return len(self.buf) + 4 * len(self.restarts) + 4


def decode_block(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    if len(data) < 4:
        return
    n_restarts = struct.unpack_from("<I", data, len(data) - 4)[0]
    limit = len(data) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < limit:
        shared, pos = get_varint(data, pos)
        non_shared, pos = get_varint(data, pos)
        vlen, pos = get_varint(data, pos)
        key = key[:shared] + data[pos:pos + non_shared]
        pos += non_shared
        yield key, data[pos:pos + vlen]
        pos += vlen


class TableBuilder:
    """Writes a .ldb sorted table: data blocks + index + footer (no filter)."""

    def __init__(self, block_size: int = 4096):
        self.out = bytearray()
        self.block_size = block_size
        self.data_builder = _BlockBuilder()
        self.index_builder = _BlockBuilder(restart_interval=1)
        self.pending_key: Optional[bytes] = None

    def _write_block(self, contents: bytes) -> Tuple[int, int]:
        offset = len(self.out)
        self.out += contents
        self.out.append(0)  # kNoCompression
        crc = mask_crc(crc32c(contents + b"\x00"))
        self.out += struct.pack("<I", crc)
        return offset, len(contents)

    def _flush_data_block(self) -> None:
        if not self.data_builder.buf:
            return
        contents = self.data_builder.finish()
        offset, size = self._write_block(contents)
        handle = bytearray()
        put_varint(handle, offset)
        put_varint(handle, size)
        self.index_builder.add(self.data_builder.last_key, bytes(handle))
        self.data_builder = _BlockBuilder()

    def add(self, ikey: bytes, value: bytes) -> None:
        self.data_builder.add(ikey, value)
        if self.data_builder.size_estimate() >= self.block_size:
            self._flush_data_block()

    def finish(self) -> bytes:
        self._flush_data_block()
        meta_off, meta_size = self._write_block(_BlockBuilder().finish())
        index_off, index_size = self._write_block(self.index_builder.finish())
        footer = bytearray()
        put_varint(footer, meta_off)
        put_varint(footer, meta_size)
        put_varint(footer, index_off)
        put_varint(footer, index_size)
        footer += b"\x00" * (FOOTER_SIZE - 8 - len(footer))
        footer += struct.pack("<Q", TABLE_MAGIC)
        self.out += footer
        return bytes(self.out)


def read_table(buf: bytes, *, verify: bool = True) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (internal_key, value) from a sorted table file, in key order."""
    if len(buf) < FOOTER_SIZE:
        raise ValueError("table too short")
    footer = buf[-FOOTER_SIZE:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != TABLE_MAGIC:
        raise ValueError("bad table magic")
    pos = 0
    _, pos = get_varint(footer, pos)      # metaindex offset
    _, pos = get_varint(footer, pos)      # metaindex size
    index_off, pos = get_varint(footer, pos)
    index_size, pos = get_varint(footer, pos)

    def block(offset: int, size: int) -> bytes:
        contents = buf[offset:offset + size]
        ctype = buf[offset + size]
        if verify:
            crc = struct.unpack_from("<I", buf, offset + size + 1)[0]
            if unmask_crc(crc) != crc32c(contents + bytes([ctype])):
                raise ValueError(f"block crc mismatch at {offset}")
        if ctype != 0:
            raise ValueError(
                "compressed LevelDB block (snappy/zstd) — only uncompressed "
                "tables are supported by the pure-Python reader")
        return contents

    for _, handle in decode_block(block(index_off, index_size)):
        off, hpos = get_varint(handle, 0)
        size, hpos = get_varint(handle, hpos)
        yield from decode_block(block(off, size))


# -- VersionEdit / MANIFEST --------------------------------------------------


def encode_version_edit(
    *,
    comparator: Optional[str] = "leveldb.BytewiseComparator",
    log_number: Optional[int] = None,
    next_file: Optional[int] = None,
    last_seq: Optional[int] = None,
    new_files: List[Tuple[int, int, int, bytes, bytes]] = (),
) -> bytes:
    out = bytearray()
    if comparator is not None:
        put_varint(out, TAG_COMPARATOR)
        _put_len_prefixed(out, comparator.encode())
    if log_number is not None:
        put_varint(out, TAG_LOG_NUMBER)
        put_varint(out, log_number)
    if next_file is not None:
        put_varint(out, TAG_NEXT_FILE)
        put_varint(out, next_file)
    if last_seq is not None:
        put_varint(out, TAG_LAST_SEQ)
        put_varint(out, last_seq)
    for level, number, size, smallest, largest in new_files:
        put_varint(out, TAG_NEW_FILE)
        put_varint(out, level)
        put_varint(out, number)
        put_varint(out, size)
        _put_len_prefixed(out, smallest)
        _put_len_prefixed(out, largest)
    return bytes(out)


def decode_version_edit(payload: bytes) -> Dict:
    edit: Dict = {"new_files": [], "deleted_files": []}
    pos = 0
    while pos < len(payload):
        tag, pos = get_varint(payload, pos)
        if tag == TAG_COMPARATOR:
            s, pos = _get_len_prefixed(payload, pos)
            edit["comparator"] = s.decode()
        elif tag in (TAG_LOG_NUMBER, TAG_NEXT_FILE, TAG_LAST_SEQ, TAG_PREV_LOG):
            v, pos = get_varint(payload, pos)
            edit[{TAG_LOG_NUMBER: "log_number", TAG_NEXT_FILE: "next_file",
                  TAG_LAST_SEQ: "last_seq", TAG_PREV_LOG: "prev_log"}[tag]] = v
        elif tag == TAG_COMPACT_POINTER:
            _, pos = get_varint(payload, pos)
            _, pos = _get_len_prefixed(payload, pos)
        elif tag == TAG_DELETED_FILE:
            level, pos = get_varint(payload, pos)
            number, pos = get_varint(payload, pos)
            edit["deleted_files"].append((level, number))
        elif tag == TAG_NEW_FILE:
            level, pos = get_varint(payload, pos)
            number, pos = get_varint(payload, pos)
            size, pos = get_varint(payload, pos)
            smallest, pos = _get_len_prefixed(payload, pos)
            largest, pos = _get_len_prefixed(payload, pos)
            edit["new_files"].append((level, number, size, smallest, largest))
        else:
            raise ValueError(f"unknown VersionEdit tag {tag}")
    return edit


# -- DB-level reader / writer ------------------------------------------------


class LevelDBReader:
    """Read-only merged view of a LevelDB directory (Caffe LevelDBCursor
    equivalent: key-ordered iteration over live values)."""

    def __init__(self, path: str, *, verify: bool = True):
        self.path = path
        current = os.path.join(path, "CURRENT")
        if not os.path.exists(current):
            raise FileNotFoundError(f"{path}: not a LevelDB directory (no CURRENT)")
        with open(current) as f:
            manifest = f.read().strip()
        with open(os.path.join(path, manifest), "rb") as f:
            manifest_buf = f.read()

        live: Dict[int, Tuple[int, int]] = {}  # number -> (level, size)
        log_number = 0
        for record in read_log_records(manifest_buf, verify=verify):
            edit = decode_version_edit(record)
            log_number = edit.get("log_number", log_number)
            for level, number in edit["deleted_files"]:
                live.pop(number, None)
            for level, number, size, _, _ in edit["new_files"]:
                live[number] = (level, size)

        # newest entry per user key wins (highest sequence number)
        best: Dict[bytes, Tuple[int, int, bytes]] = {}

        def consider(key: bytes, seq: int, rtype: int, value: bytes) -> None:
            cur = best.get(key)
            if cur is None or seq >= cur[0]:
                best[key] = (seq, rtype, value)

        for number in sorted(live):
            fname = None
            for ext in (".ldb", ".sst"):
                cand = os.path.join(path, f"{number:06d}{ext}")
                if os.path.exists(cand):
                    fname = cand
                    break
            if fname is None:
                raise FileNotFoundError(f"live table {number:06d}.ldb missing")
            with open(fname, "rb") as f:
                for ikey, value in read_table(f.read(), verify=verify):
                    ukey, seq, rtype = split_internal_key(ikey)
                    consider(ukey, seq, rtype, value)

        for fname in sorted(os.listdir(path)):
            if not fname.endswith(".log"):
                continue
            number = int(fname.split(".")[0])
            if log_number and number < log_number:
                continue  # obsolete log already compacted into tables
            with open(os.path.join(path, fname), "rb") as f:
                for record in read_log_records(f.read(), verify=verify):
                    for seq, rtype, key, value in decode_batch(record):
                        consider(key, seq, rtype, value)

        self._items = sorted(
            (k, v) for k, (seq, rtype, v) in best.items() if rtype == TYPE_VALUE
        )

    def __len__(self) -> int:
        return len(self._items)

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        return iter(self._items)

    def get(self, key: bytes) -> Optional[bytes]:
        import bisect

        i = bisect.bisect_left(self._items, (bytes(key), b""))
        if i < len(self._items) and self._items[i][0] == bytes(key):
            return self._items[i][1]
        return None


class LevelDBWriter:
    """Bulk writer: collects entries, emits a valid DB directory.

    mode='log' (default) mimics a fresh un-compacted DB: CURRENT + MANIFEST +
    one .log holding every write. mode='table' emits a single level-0 sorted
    table registered in the MANIFEST (a compacted DB).
    """

    def __init__(self, path: str, *, mode: str = "log"):
        assert mode in ("log", "table")
        self.path = path
        self.mode = mode
        self.entries: Dict[bytes, bytes] = {}

    def put(self, key: bytes, value: bytes) -> None:
        self.entries[bytes(key)] = bytes(value)

    def close(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        items = sorted(self.entries.items())
        n = len(items)
        if self.mode == "log":
            log = LogWriter()
            for i, (k, v) in enumerate(items):
                log.add_record(encode_batch(i + 1, [(TYPE_VALUE, k, v)]))
            with open(os.path.join(self.path, "000003.log"), "wb") as f:
                f.write(log.data())
            edit = encode_version_edit(log_number=3, next_file=4, last_seq=n)
        else:
            tb = TableBuilder()
            for i, (k, v) in enumerate(items):
                tb.add(internal_key(k, i + 1), v)
            with open(os.path.join(self.path, "000005.ldb"), "wb") as f:
                table = tb.finish()
                f.write(table)
            smallest = internal_key(items[0][0], 1) if items else b""
            largest = internal_key(items[-1][0], n) if items else b""
            edit = encode_version_edit(
                log_number=6, next_file=7, last_seq=n,
                new_files=[(0, 5, len(table), smallest, largest)])
            open(os.path.join(self.path, "000006.log"), "wb").close()
        mlog = LogWriter()
        mlog.add_record(edit)
        with open(os.path.join(self.path, "MANIFEST-000002"), "wb") as f:
            f.write(mlog.data())
        with open(os.path.join(self.path, "CURRENT"), "w") as f:
            f.write("MANIFEST-000002\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
