"""The port's index integrity against the JAX package: its CRC-32C and
chunk checksums equal ``repro.index.integrity``'s bit for bit, a JAX-built
checksummed fp16 index with one flipped byte is refused at open by both
readers, ``verify_reads`` re-checks only the chunks a read touches, a
clean index scores as before, and an index without checksums opens
unverified and refuses ``verify_reads``.

Scores compare as in tests/test_torch_index_serving.py: float32 compute
over the same stored fp16 bytes, rtol = atol = 2e-5."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.index import IndexBuilder as JaxIndexBuilder
from repro.index import IndexIntegrityError as JaxIndexIntegrityError
from repro.index import TermRepIndex as JaxTermRepIndex
from repro.index import integrity as JI
from repro.serving.service import RankingService as JaxRankingService
from repro.serving.service import RankRequest as JaxRankRequest
from repro_torch.index import (IndexBuilder, IndexFormatError,
                               IndexIntegrityError, TermRepIndex)
from repro_torch.index import integrity as TI
from repro_torch.serving import RankingService, RankRequest
from test_torch_index_serving import (_configs, _port_params, _serve,
                                      _world)

CHUNK = 256                  # 8 fp16 rows of 16 values: many chunks a shard
TOL = dict(rtol=2e-5, atol=2e-5)


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _jax_build(path):
    jparams, docs, _ = _world()
    jcfg, _ = _configs()
    JaxIndexBuilder(path, jcfg, jax.tree.map(jnp.asarray, jparams),
                    codec="fp16", n_shards=2, batch_size=8,
                    checksum_chunk_bytes=CHUNK).build(docs)
    return path


@pytest.fixture
def jax_index(tmp_path):
    return _jax_build(str(tmp_path / "idx"))


@pytest.mark.parametrize("n_bytes", [0, 1, CHUNK, 3 * CHUNK,
                                     3 * CHUNK + 17, CHUNK - 5])
def test_crc32c_matches_jax_bit_for_bit(n_bytes, tmp_path):
    """Empty input, one byte, exact chunk multiples (one chunk, and the
    vectorised many-chunk path), a tail shorter than a chunk, and a file
    shorter than one chunk."""
    data = np.random.default_rng(n_bytes).integers(
        0, 256, n_bytes, dtype=np.uint8)
    assert TI.crc32c(data) == JI.crc32c(data)
    assert TI.crc32c(data.tobytes()) == JI.crc32c(data.tobytes())
    assert TI.crc32c(data, 0x1234) == JI.crc32c(data, 0x1234)
    got = TI.chunk_checksums(data, CHUNK)
    assert got == JI.chunk_checksums(data, CHUNK)
    assert len(got) == -(-n_bytes // CHUNK)
    fp = tmp_path / "stream.bin"
    data.tofile(fp)
    assert (TI.file_chunk_checksums(str(fp), CHUNK)
            == JI.file_chunk_checksums(str(fp), CHUNK) == got)
    assert TI.crc32c(b"123456789") == 0xE3069283
    with pytest.raises(ValueError, match="chunk_bytes"):
        TI.chunk_checksums(data, 0)


# sizes around the sub-block fold: empty, under one sub-block, one
# sub-block, odd remainders, one chunk, chunk tails, many chunks
SUB = TI.SUB_BLOCK
FOLD_SIZES = [0, 1, SUB - 1, SUB, SUB + 1, 3 * SUB + 5, 1000, 4096,
              65536 + 13, 200_003]
FOLD_CHUNKS = [1, 7, SUB, SUB + 24, 1000, 4096, 65536]


@pytest.mark.parametrize("n_bytes", FOLD_SIZES)
def test_sub_block_fold_matches_jax_bit_for_bit(n_bytes):
    """The sub-block CRCs folded by the zero-append operator equal JAX's
    checksums for every chunk size, chunk sizes the sub-block does not
    divide (zero-padded in front) among them, and the scalar
    ``crc32c``, chained ``value`` too."""
    data = np.random.default_rng(7 + n_bytes).integers(
        0, 256, n_bytes, dtype=np.uint8)
    for chunk in FOLD_CHUNKS:
        if n_bytes // chunk > 4096:      # the JAX loop is per position
            continue
        assert TI.chunk_checksums(data, chunk) \
            == JI.chunk_checksums(data, chunk), chunk
    for value in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
        assert TI.crc32c(data, value) == JI.crc32c(data, value), value
    cut = n_bytes // 3
    assert TI.crc32c(data[cut:], TI.crc32c(data[:cut])) \
        == TI.crc32c(data) == JI.crc32c(data.tobytes())


def test_zero_append_operator_is_the_register_after_zero_bytes():
    """``Z_n`` (columns, and as two 16-bit tables) equals running the
    register through ``n`` zero bytes one at a time."""
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 3, 8, 63, 64, 1000, 65536):
        regs = rng.integers(0, 1 << 32, 16, dtype=np.uint64) \
            .astype(np.uint32)
        want = [TI._crc_scalar(bytes(n), int(r)) for r in regs]
        assert [TI._apply(TI._zeros_map(n), int(r)) for r in regs] == want
        assert TI._shift(regs, n).tolist() == want


def test_a_flipped_byte_is_refused_at_open_by_both_readers(jax_index):
    ours = TermRepIndex.open(jax_index)
    n_chunks = ours.verify_integrity()
    assert n_chunks == JaxTermRepIndex.open(jax_index).verify_integrity()
    assert n_chunks > 2 * ours.n_shards
    first = ours._stream_paths[0]["reps"]
    _flip_byte(first, 10)
    with pytest.raises(IndexIntegrityError,
                       match=r"shard-00000/reps\.bin: chunk 0 CRC-32C"):
        TermRepIndex.open(jax_index)
    with pytest.raises(JaxIndexIntegrityError, match="chunk 0"):
        JaxTermRepIndex.open(jax_index)
    assert issubclass(IndexIntegrityError, IndexFormatError)
    # verify=False skips the pass; the corrupt bytes are then served
    unchecked = TermRepIndex.open(jax_index, verify=False)
    assert len(unchecked) == len(ours)
    with pytest.raises(IndexIntegrityError):
        unchecked.verify_integrity()


def test_verify_reads_raises_only_on_the_corrupt_chunk(jax_index):
    idx = TermRepIndex.open(jax_index, verify_reads=True)
    jidx = JaxTermRepIndex.open(jax_index, verify_reads=True)
    table = idx._doc_table
    dt, row_shape = idx.streams_spec()["reps"]
    rowbytes = dt.itemsize * int(np.prod(row_shape))
    in_chunk0 = [i for i, (sh, start, n) in enumerate(table)
                 if sh == 0 and start * rowbytes < CHUNK]
    clear = [i for i, (sh, start, n) in enumerate(table)
             if sh == 1 or start * rowbytes >= CHUNK]
    assert in_chunk0 and clear
    clean_parts, clean_valid = idx.gather_raw(clear)
    _flip_byte(idx._stream_paths[0]["reps"], 10)
    for reader, err in ((idx, IndexIntegrityError),
                        (jidx, JaxIndexIntegrityError)):
        with pytest.raises(err, match="chunk 0 CRC-32C mismatch on read"):
            reader.gather_raw([clear[0], in_chunk0[0]])
    with pytest.raises(IndexIntegrityError, match="mismatch on read"):
        idx.stage(in_chunk0[:1], device="cpu")
    parts, valid = idx.gather_raw(clear)
    np.testing.assert_array_equal(parts["reps"], clean_parts["reps"])
    np.testing.assert_array_equal(valid, clean_valid)
    tparts, _ = idx.stage(clear, device="cpu")
    np.testing.assert_array_equal(tparts["reps"].numpy(), clean_parts["reps"])
    _flip_byte(idx._stream_paths[0]["reps"], 10)          # restore
    idx.gather_raw(in_chunk0)
    assert idx.verify_integrity() > 0


def test_a_clean_verified_index_scores_as_before(jax_index):
    """Opening with both checks on changes no score: the port serves the
    checksummed JAX index like the JAX service does."""
    jcfg, tcfg = _configs("plain")
    want = _serve(JaxRankingService(
        jax.tree.map(jnp.asarray, _world()[0]), jcfg,
        JaxTermRepIndex.open(jax_index), micro_batch=4), JaxRankRequest)
    got = _serve(RankingService(
        _port_params(tcfg), tcfg,
        TermRepIndex.open(jax_index, verify=True, verify_reads=True),
        micro_batch=4, device="cpu"), RankRequest)
    assert sorted(got) == sorted(want)
    for rid, resp in got.items():
        assert resp.doc_ids == [int(i) for i in want[rid].doc_ids]
        np.testing.assert_allclose(resp.scores, np.asarray(want[rid].scores),
                                   **TOL)


def test_an_index_without_checksums_opens_unverified(tmp_path):
    """An index built without checksums (``checksum_chunk_bytes=0``; the
    port's builder writes them by default) opens unverified in both
    packages and both refuse ``verify_reads``."""
    _, tcfg = _configs()
    path = str(tmp_path / "port")
    IndexBuilder(path, tcfg, _port_params(tcfg), codec="fp16",
                 batch_size=8, checksum_chunk_bytes=0,
                 device="cpu").build(_world()[1][:6])
    idx = TermRepIndex.open(path)
    assert idx.verify_integrity() == 0 and not idx.verify_reads
    with pytest.raises(ValueError, match="no chunk checksums"):
        TermRepIndex.open(path, verify_reads=True)
    with pytest.raises(ValueError, match="no chunk checksums"):
        JaxTermRepIndex.open(path, verify_reads=True)
    _flip_byte(idx._stream_paths[0]["reps"], 10)     # nothing to catch it
    TermRepIndex.open(path)
