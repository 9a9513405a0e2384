"""mscnn_torch/io/leveldb.py against mscnn_tpu/io/leveldb.py.

The port's `LevelDBWriter` writes the JAX writer's directory byte for byte
(table, tail log, MANIFEST, CURRENT; compressed and not, many blocks,
values larger than a block, every entry in the log), and each package's
reader reads the other's, checksums verified. The port's crc32c (numpy
lanes, `_crc32c_many`) equals JAX's byte loop at every length class; the
log and snappy codecs, the deletion / overwrite merge and the refusals are
JAX's.
"""

import os
import struct

import numpy as np
import pytest

from mscnn_tpu.io import leveldb as JLDB
from mscnn_torch.io import leveldb as TLDB


def _items(case):
    rng = np.random.RandomState(5)
    if case in ("small", "log_only"):
        return [(f"k{i:03d}".encode(), bytes([i]) * (i + 1)) for i in range(20)][::-1]
    # values above a 4 KiB block and enough keys for several blocks and
    # restart intervals
    return [(f"{i:08d}_im".encode(), rng.bytes(int(rng.randint(10, 9000))))
            for i in range(150)]


KW = {"small": {}, "log_only": {"log_tail": 99},
      "many_blocks": {"log_tail": 5}, "uncompressed": {"compress": False}}


def _write(mod, path, items, **kw):
    with mod.LevelDBWriter(path, **kw) as db:
        for k, v in items:
            db.put(k, v)
    return path


@pytest.mark.parametrize("case", sorted(KW))
def test_writer_bytes_equal_jax_and_each_reads_the_other(tmp_path, case):
    items = _items(case)
    jp = _write(JLDB, str(tmp_path / "j"), items, **KW[case])
    tp = _write(TLDB, str(tmp_path / "t"), items, **KW[case])
    assert sorted(os.listdir(jp)) == sorted(os.listdir(tp))
    for name in os.listdir(jp):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    with TLDB.LevelDBReader(jp, verify_checksums=True) as t, \
            JLDB.LevelDBReader(tp, verify_checksums=True) as j:
        assert list(t.items()) == list(j.items()) == sorted(items)
        assert t.get(items[0][0]) == j.get(items[0][0]) == items[0][1]
        assert t.get(b"absent") is None
    assert TLDB.is_leveldb_dir(tp) and not TLDB.is_leveldb_dir(str(tmp_path))


def test_crc32c_matches_jax():
    rng = np.random.RandomState(0)
    lengths = [0, 1, 2, 3, 4, 5, 63, 64, 65, 127, 128, 129, 4095, 4096, 4097,
               9000, 70001]
    bufs = [rng.bytes(n) for n in lengths] + [b"\xff" * 37, bytes(100)]
    want = [JLDB._crc32c(b) for b in bufs]
    assert TLDB._crc32c_many(bufs) == want
    assert [TLDB._crc32c(b) for b in bufs] == want
    assert TLDB._crc32c(b"123456789") == 0xE3069283       # the CRC-32C check value
    for v in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
        assert TLDB._unmask_crc(TLDB._mask_crc(v)) == v
        assert TLDB._mask_crc(v) == JLDB._mask_crc(v)


def test_log_and_snappy_codecs_match_jax():
    rec = bytes(range(256)) * 400           # ~100 KiB: FIRST / MIDDLE / LAST
    data = TLDB._log_write([b"small", rec, b"tail"])
    assert data == JLDB._log_write([b"small", rec, b"tail"])
    assert list(TLDB._log_records(data, verify=True)) == [b"small", rec, b"tail"]
    lit = bytes(range(70))
    streams = [bytes([8, 3 << 2]) + b"abab" + bytes([1, 4]),             # copy1
               bytes([8, 1 << 2]) + b"ab" + bytes([(2 << 2) | 1, 2]),    # overlapping
               TLDB._put_varint(134) + bytes([60 << 2, 69]) + lit
               + bytes([(63 << 2) | 2]) + struct.pack("<H", 70),         # copy2
               bytes([8, 3 << 2]) + b"wxyz" + bytes([(3 << 2) | 3])
               + struct.pack("<I", 4)]                                   # copy4
    for s in streams:
        assert TLDB.snappy_decompress(s) == JLDB.snappy_decompress(s)
    for n in (1, 59, 60, 61, 200, 257, 70000):
        data = np.random.RandomState(n % 97).bytes(n)
        enc = TLDB._snappy_compress_literal(data)
        assert enc == JLDB._snappy_compress_literal(data)
        assert TLDB.snappy_decompress(enc) == data


def test_deletion_overwrite_and_refusals_match_jax(tmp_path):
    """Newest sequence wins and deletions drop keys (a hand-written tail
    log over a table), in both readers; both refuse what is not a
    LevelDB."""
    p = _write(JLDB, str(tmp_path / "db"),
               [(b"a", b"old"), (b"b", b"keep"), (b"c", b"dead")], log_tail=0)
    body = struct.pack("<Q", 100) + struct.pack("<I", 3)
    body += bytes([1, 1]) + b"a" + bytes([3]) + b"new"
    body += bytes([0, 1]) + b"c"
    body += bytes([1, 1]) + b"d" + bytes([2]) + b"dd"
    with open(os.path.join(p, "000007.log"), "wb") as f:
        f.write(TLDB._log_write([body]))
    with TLDB.LevelDBReader(p, verify_checksums=True) as t, \
            JLDB.LevelDBReader(p, verify_checksums=True) as j:
        assert list(t.items()) == list(j.items()) == [
            (b"a", b"new"), (b"b", b"keep"), (b"d", b"dd")]
    d = tmp_path / "not_a_db"
    d.mkdir()
    with pytest.raises(TLDB.LevelDBError, match="CURRENT"):
        TLDB.LevelDBReader(str(d))
    (d / "CURRENT").write_bytes(b"MANIFEST-000002\n")
    (d / "MANIFEST-000002").write_bytes(TLDB._log_write([b"\xff\xff\x7f"]))
    with pytest.raises(TLDB.LevelDBError, match="VersionEdit"):
        TLDB.LevelDBReader(str(d))
    table = bytearray((tmp_path / "db" / "000005.ldb").read_bytes())
    table[3] ^= 1
    (tmp_path / "db" / "000005.ldb").write_bytes(bytes(table))
    with pytest.raises(TLDB.LevelDBError, match="crc"):
        TLDB.LevelDBReader(p, verify_checksums=True)
