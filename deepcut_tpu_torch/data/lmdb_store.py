"""Pure-Python LMDB environment reader/writer (read path + minimal writer).

The reference's DB abstraction (src/caffe/util/db_lmdb.cpp) links liblmdb;
this image has neither liblmdb nor the `lmdb` wheel, so we implement the
on-disk format directly from its public specification: a copy-on-write B+tree
in a memory-mapped file, dual meta pages, 4 KiB pages.

Reader: full-format iteration/lookup of the main DB (branch/leaf/overflow
pages, big-data nodes). Writer: bulk builder that lays out sorted entries
into leaf pages + a branch spine + meta page — enough for `convert_imageset`
-style dataset creation and for round-trip tests. DUPSORT databases are not
supported (Caffe never uses them).

The port's own copy of `deepcut_tpu.data.lmdb_store` (jax-free; held against the
original by tests/test_torch_data_layers.py).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

PAGE_SIZE = 4096
PAGEHDRSZ = 16
MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

_META_DB = struct.Struct("<IHHQQQQQ")        # pad, flags, depth, branch, leaf, overflow, entries, root
_NODE_HDR = struct.Struct("<HHHH")           # lo, hi, flags, ksize


class LMDBReader:
    def __init__(self, path: str):
        import mmap

        data_path = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
        with open(data_path, "rb") as f:
            # mmap instead of read(): a 100+ GB ImageNet-style env must not
            # be slurped into RSS; pages fault in on demand like liblmdb
            self.buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        # meta page 0 is always at offset 0; its recorded page size (set to
        # the CREATING host's OS page size, not necessarily 4096) locates
        # meta page 1
        meta0 = self._read_meta(0, PAGE_SIZE)
        meta1 = self._read_meta(1, meta0["psize"])
        self.meta = meta0 if meta0["txnid"] >= meta1["txnid"] else meta1
        self.psize = self.meta["psize"]
        self.root = self.meta["main_root"]
        self.entries = self.meta["main_entries"]

    def _read_meta(self, pgno: int, psize: int) -> Dict:
        off = pgno * psize
        flags = struct.unpack_from("<H", self.buf, off + 10)[0]
        if not flags & P_META:
            raise ValueError(f"page {pgno} is not a meta page")
        m = off + PAGEHDRSZ
        magic, version = struct.unpack_from("<II", self.buf, m)
        if magic != MDB_MAGIC:
            raise ValueError("bad LMDB magic")
        mapaddr, mapsize = struct.unpack_from("<QQ", self.buf, m + 8)
        psize = struct.unpack_from("<I", self.buf, m + 24 + 0)[0] or PAGE_SIZE
        # mm_dbs[0] = FREE, mm_dbs[1] = MAIN; each is _META_DB
        free_off = m + 24
        # layout: magic(4) version(4) address(8) mapsize(8) dbs[2] last_pg(8) txnid(8)
        dbs_off = m + 24
        free = _META_DB.unpack_from(self.buf, dbs_off)
        main = _META_DB.unpack_from(self.buf, dbs_off + _META_DB.size)
        last_pg, txnid = struct.unpack_from("<QQ", self.buf, dbs_off + 2 * _META_DB.size)
        return {
            "psize": free[0] or PAGE_SIZE,  # mm_dbs[0].md_pad holds page size
            "main_root": main[7],
            "main_entries": main[6],
            "txnid": txnid,
        }

    # -- page access -------------------------------------------------------
    def _page(self, pgno: int) -> Tuple[int, int]:
        off = pgno * self.psize
        flags = struct.unpack_from("<H", self.buf, off + 10)[0]
        return off, flags

    def _page_nodes(self, off: int) -> List[int]:
        lower = struct.unpack_from("<H", self.buf, off + 12)[0]
        n = (lower - PAGEHDRSZ) // 2
        return [off + struct.unpack_from("<H", self.buf, off + PAGEHDRSZ + 2 * i)[0]
                for i in range(n)]

    def _node(self, noff: int, leaf: bool):
        lo, hi, flags, ksize = _NODE_HDR.unpack_from(self.buf, noff)
        key = self.buf[noff + 8: noff + 8 + ksize]
        if leaf:
            dsize = lo | (hi << 16)
            if flags & F_BIGDATA:
                ov_pgno = struct.unpack_from("<Q", self.buf, noff + 8 + ksize)[0]
                ooff, oflags = self._page(ov_pgno)
                data = self.buf[ooff + PAGEHDRSZ: ooff + PAGEHDRSZ + dsize]
            else:
                data = self.buf[noff + 8 + ksize: noff + 8 + ksize + dsize]
            return key, data
        pgno = lo | (hi << 16) | (flags << 32)
        return key, pgno

    def _iter_page(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        off, flags = self._page(pgno)
        if flags & P_LEAF:
            for noff in self._page_nodes(off):
                yield self._node(noff, leaf=True)
        elif flags & P_BRANCH:
            for noff in self._page_nodes(off):
                _, child = self._node(noff, leaf=False)
                yield from self._iter_page(child)
        else:
            raise ValueError(f"unexpected page flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self.root == 0xFFFFFFFFFFFFFFFF:  # P_INVALID: empty db
            return
        yield from self._iter_page(self.root)

    def get(self, key: bytes) -> Optional[bytes]:
        for k, v in self.items():
            if k == key:
                return v
        return None

    def __len__(self) -> int:
        return int(self.entries)

    def close(self) -> None:
        self.buf.close()


class LMDBWriter:
    """Bulk writer: collects entries, sorts, emits a valid single-version env."""

    def __init__(self, path: str):
        self.path = path
        self.entries: Dict[bytes, bytes] = {}

    def put(self, key: bytes, value: bytes) -> None:
        self.entries[bytes(key)] = bytes(value)

    def _leaf_node(self, key: bytes, value: bytes, overflow_pgno: Optional[int]):
        if overflow_pgno is None:
            dsize = len(value)
            return _NODE_HDR.pack(dsize & 0xFFFF, dsize >> 16, 0, len(key)) + key + value
        dsize = len(value)
        return _NODE_HDR.pack(dsize & 0xFFFF, dsize >> 16, F_BIGDATA, len(key)) + \
            key + struct.pack("<Q", overflow_pgno)

    def _branch_node(self, key: bytes, pgno: int):
        return _NODE_HDR.pack(pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                              (pgno >> 32) & 0xFFFF, len(key)) + key

    def _emit_page(self, pages: List[bytes], flags: int, nodes: List[bytes]) -> int:
        pgno = len(pages)
        ptrs: List[int] = []
        upper = PAGE_SIZE
        body = bytearray(PAGE_SIZE)
        # nodes are placed from the top down, pointers from the bottom up
        for node in nodes:
            upper -= len(node)
            if upper % 2:
                upper -= 1
            body[upper:upper + len(node)] = node
            ptrs.append(upper)
        lower = PAGEHDRSZ + 2 * len(nodes)
        struct.pack_into("<QHHHH", body, 0, pgno, 0, flags, lower, upper)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", body, PAGEHDRSZ + 2 * i, p)
        pages.append(bytes(body))
        return pgno

    def close(self) -> None:
        items = sorted(self.entries.items())
        pages: List[bytes] = [b"", b""]  # meta pages filled last

        # data pages
        leaf_entries: List[Tuple[bytes, bytes, Optional[int]]] = []
        prepared: List[Tuple[bytes, bytes, Optional[int]]] = []
        for key, value in items:
            node_sz = 8 + len(key) + len(value)
            if node_sz > (PAGE_SIZE - PAGEHDRSZ) // 2:
                npages = -(-len(value) // (PAGE_SIZE - PAGEHDRSZ))
                ov_pgno = len(pages)
                ov = bytearray(npages * PAGE_SIZE)
                struct.pack_into("<QHHI", ov, 0, ov_pgno, 0, P_OVERFLOW, npages)
                ov[PAGEHDRSZ:PAGEHDRSZ + len(value)] = value
                for i in range(npages):
                    pages.append(bytes(ov[i * PAGE_SIZE:(i + 1) * PAGE_SIZE]))
                prepared.append((key, value, ov_pgno))
            else:
                prepared.append((key, value, None))

        leaf_pgnos: List[Tuple[bytes, int]] = []  # (first key, pgno)
        cur_nodes: List[bytes] = []
        cur_first: Optional[bytes] = None
        cur_size = 0
        budget = PAGE_SIZE - PAGEHDRSZ

        def flush_leaf():
            nonlocal cur_nodes, cur_first, cur_size
            if cur_nodes:
                pgno = self._emit_page(pages, P_LEAF, cur_nodes)
                leaf_pgnos.append((cur_first, pgno))
                cur_nodes, cur_first, cur_size = [], None, 0

        for key, value, ov in prepared:
            node = self._leaf_node(key, value, ov)
            need = len(node) + (len(node) % 2) + 2
            if cur_size + need > budget:
                flush_leaf()
            if cur_first is None:
                cur_first = key
            cur_nodes.append(node)
            cur_size += need
        flush_leaf()

        depth = 1
        level = leaf_pgnos
        branch_pages = 0
        while len(level) > 1:
            depth += 1
            next_level: List[Tuple[bytes, int]] = []
            nodes: List[bytes] = []
            first: Optional[bytes] = None
            size = 0
            for i, (key, pgno) in enumerate(level):
                # LMDB convention: the leftmost branch node at a level carries
                # an empty key; our reader iterates all children regardless.
                node = self._branch_node(b"" if i == 0 else key, pgno)
                need = len(node) + (len(node) % 2) + 2
                if size + need > budget:
                    bp = self._emit_page(pages, P_BRANCH, nodes)
                    branch_pages += 1
                    next_level.append((first, bp))
                    nodes, first, size = [], None, 0
                if first is None:
                    first = key
                nodes.append(node)
                size += need
            if nodes:
                bp = self._emit_page(pages, P_BRANCH, nodes)
                branch_pages += 1
                next_level.append((first, bp))
            level = next_level

        root = level[0][1] if level else 0xFFFFFFFFFFFFFFFF
        leaf_count = len(leaf_pgnos)

        # meta page (slot 0; slot 1 left with txnid 0)
        def meta_page(pgno: int, txnid: int) -> bytes:
            body = bytearray(PAGE_SIZE)
            struct.pack_into("<QHHHH", body, 0, pgno, 0, P_META, 0, 0)
            m = PAGEHDRSZ
            struct.pack_into("<II", body, m, MDB_MAGIC, MDB_VERSION)
            struct.pack_into("<QQ", body, m + 8, 0, len(pages) * PAGE_SIZE)
            dbs = m + 24
            _META_DB.pack_into(body, dbs, PAGE_SIZE, 0, 0, 0, 0, 0, 0,
                               0xFFFFFFFFFFFFFFFF)  # FREE db: empty
            _META_DB.pack_into(body, dbs + _META_DB.size, 0, 0, depth,
                               branch_pages, leaf_count, 0, len(items), root)
            struct.pack_into("<QQ", body, dbs + 2 * _META_DB.size,
                             len(pages) - 1, txnid)
            return bytes(body)

        pages[0] = meta_page(0, 1)
        pages[1] = meta_page(1, 0)

        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, "data.mdb"), "wb") as f:
            f.write(b"".join(pages))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
