"""Blosc1 chunk codec — spec-derived, pure Python/numpy.

OpenVDB built against c-blosc (the default for Houdini and most VFX
builds) frames every compressed value payload as {int64 n; n>0: n blosc
bytes, n<=0: -n raw bytes} and hands the payload to blosc_decompress
(openvdb io/Compression.cc `bloscDecompress`; the reference consumes such
files through the OpenVDB library, ref: src/Utils/Utils.hpp:361-403).
A TPU host has no blosc build, so this module implements the c-blosc1
chunk format itself — decode for ingesting real assets, encode so the
repo's `.vdb` writer can emit ecosystem-default files and so the decoder
has a round-trip sparring partner (the same pair methodology as
format/vqvdb.py and vdb/openvdb_io.py).

Chunk layout (c-blosc1, BLOSC_VERSION_FORMAT 2; little-endian):

  header (16 B):
      u8  version        (format version, 2)
      u8  versionlz      (codec format version, 1)
      u8  flags          bit0 byte-shuffle, bit1 memcpyed,
                         bit2 bit-shuffle, bit4 dont-split,
                         bits5-7 codec id (0 blosclz, 1 lz4/lz4hc,
                         2 snappy, 3 zlib, 4 zstd)
      u8  typesize
      u32 nbytes         (uncompressed size)
      u32 blocksize
      u32 cbytes         (total chunk size, header included)

  memcpyed chunks: the nbytes raw bytes follow the header directly.

  otherwise: i32 bstarts[nblocks] — absolute chunk offsets of each
  compressed block (nblocks = ceil(nbytes/blocksize)) — then the blocks.
  Each block stores `nsplits` streams, each framed {i32 sbytes, payload}:
  sbytes equal to the stream's uncompressed size marks a stored
  (uncompressed) stream, anything else is codec-compressed. nsplits is
  `typesize` when the block is split (typesize <= 16, blocksize/typesize
  >= 128, not the leftover block, dont-split flag clear), else 1.

  Byte-shuffle operates per block before compression: the block is read
  as [nelem, typesize] bytes and transposed to [typesize, nelem]; a
  trailing `blocksize % typesize` remainder is kept verbatim. Decode
  inverts this per block after decompression.

LZ4 block format (the codec OpenVDB pins, BLOSC_LZ4_COMPNAME): sequences
of {token, literals, 2-B LE match offset, extended lengths}; high token
nibble = literal count, low nibble = match length - 4, value 15 chains
255-saturated extension bytes; the final sequence is literals-only.
"""

from __future__ import annotations

import struct

import numpy as np

from vqvdb_tpu_torch.utils.errors import FormatError

VERSION_FORMAT = 2
VERSION_LZ4 = 1

FLAG_BYTE_SHUFFLE = 0x1
FLAG_MEMCPYED = 0x2
FLAG_BIT_SHUFFLE = 0x4
FLAG_DONT_SPLIT = 0x10

CODEC_BLOSCLZ = 0
CODEC_LZ4 = 1
CODEC_SNAPPY = 2
CODEC_ZLIB = 3
CODEC_ZSTD = 4
_CODEC_NAMES = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}

MAX_SPLITS = 16       # c-blosc MAX_SPLITS
MIN_BUFFERSIZE = 128  # c-blosc BLOSC_MIN_BUFFERSIZE
MAX_OVERHEAD = 16     # header bytes
MAX_TYPESIZE = 255

HEADER = struct.Struct("<BBBBIII")


# ---------------------------------------------------------------------------
# LZ4 block codec
# ---------------------------------------------------------------------------

def lz4_decompress(src, dst_size: int) -> bytes:
    """Decode one LZ4 block to exactly `dst_size` bytes."""
    src = bytes(src)
    n = len(src)
    dst = bytearray()
    i = 0
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise FormatError("lz4: truncated literal length")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if lit:
            if i + lit > n:
                raise FormatError("lz4: literal run past end of input")
            dst += src[i : i + lit]
            i += lit
        if i >= n:
            break  # final sequence carries no match
        if i + 2 > n:
            raise FormatError("lz4: truncated match offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(dst):
            raise FormatError(f"lz4: invalid match offset {offset}")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if i >= n:
                    raise FormatError("lz4: truncated match length")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(dst) - offset
        if offset >= mlen:
            dst += dst[start : start + mlen]
        else:
            # Overlapping match: the pattern [start:] repeats.
            pattern = bytes(dst[start:])
            reps = -(-mlen // offset)
            dst += (pattern * reps)[:mlen]
    if len(dst) != dst_size:
        raise FormatError(
            f"lz4: block decoded to {len(dst)} bytes, expected {dst_size}")
    return bytes(dst)


def _put_len(out: bytearray, v: int) -> None:
    while v >= 255:
        out.append(255)
        v -= 255
    out.append(v)


def lz4_compress(src) -> bytes:
    """Greedy single-pass LZ4 block encoder (hash table over 4-grams).

    Honours the end-of-block rules: no match starts within the last 12
    bytes and none extends into the last 5, so any conforming decoder
    (including real liblz4) accepts the output.
    """
    src = bytes(src)
    n = len(src)
    out = bytearray()
    table: dict = {}
    anchor = 0
    i = 0
    limit = n - 12
    while i < limit:
        key = src[i : i + 4]
        cand = table.get(key, -1)
        table[key] = i
        if cand >= 0 and i - cand <= 0xFFFF:
            # Extend the match; it may not reach into the final 5 bytes.
            end = n - 5
            m, c = i + 4, cand + 4
            while m < end and src[m] == src[c]:
                m += 1
                c += 1
            mlen = m - i
            lit = i - anchor
            ml = mlen - 4
            out.append((min(lit, 15) << 4) | min(ml, 15))
            if lit >= 15:
                _put_len(out, lit - 15)
            out += src[anchor:i]
            out += (i - cand).to_bytes(2, "little")
            if ml >= 15:
                _put_len(out, ml - 15)
            # Index a couple of positions inside the match so runs chain.
            step = max(1, mlen // 4)
            for j in range(i + 1, min(m, limit), step):
                table[src[j : j + 4]] = j
            i = m
            anchor = m
        else:
            i += 1
    lit = n - anchor
    out.append(min(lit, 15) << 4)
    if lit >= 15:
        _put_len(out, lit - 15)
    out += src[anchor:]
    return bytes(out)


# ---------------------------------------------------------------------------
# Shuffle filter
# ---------------------------------------------------------------------------

def _shuffle(block: bytes, typesize: int) -> bytes:
    nelem = len(block) // typesize
    body = nelem * typesize
    arr = np.frombuffer(block[:body], np.uint8).reshape(nelem, typesize)
    return arr.T.tobytes() + block[body:]


def _unshuffle(block: bytes, typesize: int) -> bytes:
    nelem = len(block) // typesize
    body = nelem * typesize
    arr = np.frombuffer(block[:body], np.uint8).reshape(typesize, nelem)
    return arr.T.tobytes() + block[body:]


def _split_block(codec: int, typesize: int, blocksize: int) -> bool:
    """c-blosc's split_block (forward-compat mode): split only for the
    codecs whose streams benefit, on shuffled-friendly geometry."""
    return (codec in (CODEC_BLOSCLZ, CODEC_LZ4)
            and 1 < typesize <= MAX_SPLITS
            and blocksize // typesize >= MIN_BUFFERSIZE)


def _nsplits(typesize: int, blocksize: int, leftover: bool,
             dont_split: bool) -> int:
    if (typesize <= MAX_SPLITS and blocksize // typesize >= MIN_BUFFERSIZE
            and not leftover and not dont_split):
        return typesize
    return 1


# ---------------------------------------------------------------------------
# Chunk decode
# ---------------------------------------------------------------------------

def decompress(chunk) -> bytes:
    """Decode one blosc1 chunk to its uncompressed bytes."""
    chunk = bytes(chunk)
    if len(chunk) < MAX_OVERHEAD:
        raise FormatError(f"blosc chunk shorter than header ({len(chunk)} B)")
    (version, _versionlz, flags, typesize, nbytes, blocksize,
     cbytes) = HEADER.unpack_from(chunk)
    if version > 0x10:  # c-blosc wrote 1/2; anything large is garbage
        raise FormatError(f"implausible blosc format version {version}")
    if cbytes != len(chunk):
        raise FormatError(
            f"blosc chunk header says {cbytes} B, payload is {len(chunk)} B")
    if nbytes == 0:
        return b""
    if flags & FLAG_MEMCPYED:
        if len(chunk) < MAX_OVERHEAD + nbytes:
            raise FormatError("blosc memcpyed chunk truncated")
        return chunk[MAX_OVERHEAD : MAX_OVERHEAD + nbytes]

    codec = (flags >> 5) & 0x7
    if flags & FLAG_BIT_SHUFFLE:
        raise FormatError(
            "blosc bit-shuffle filter is not supported (OpenVDB/Houdini "
            "never write it); re-save the asset with byte shuffle")
    if codec not in (CODEC_LZ4, CODEC_ZLIB):
        raise FormatError(
            f"blosc codec '{_CODEC_NAMES.get(codec, codec)}' is not "
            "supported (OpenVDB pins lz4); re-save the asset")
    if typesize == 0 or blocksize == 0:
        raise FormatError("blosc chunk with zero typesize/blocksize")

    nblocks = -(-nbytes // blocksize)
    leftover = nbytes % blocksize
    starts = struct.unpack_from(f"<{nblocks}i", chunk, MAX_OVERHEAD)
    dont_split = bool(flags & FLAG_DONT_SPLIT)
    shuffled = bool(flags & FLAG_BYTE_SHUFFLE)

    out = bytearray()
    for bi in range(nblocks):
        bsize = leftover if (bi == nblocks - 1 and leftover) else blocksize
        is_leftover = bsize != blocksize
        pos = starts[bi]
        if pos < MAX_OVERHEAD or pos > len(chunk):
            raise FormatError(f"blosc block start {pos} out of range")
        nsplits = _nsplits(typesize, bsize, is_leftover, dont_split)
        neblock = bsize // nsplits
        parts = []
        for _ in range(nsplits):
            if pos + 4 > len(chunk):
                raise FormatError("blosc stream header past end of chunk")
            (sbytes,) = struct.unpack_from("<i", chunk, pos)
            pos += 4
            if sbytes < 0 or pos + sbytes > len(chunk):
                raise FormatError(f"blosc stream size {sbytes} out of range")
            payload = chunk[pos : pos + sbytes]
            pos += sbytes
            if sbytes == neblock:
                parts.append(payload)  # stored verbatim
            elif codec == CODEC_LZ4:
                parts.append(lz4_decompress(payload, neblock))
            else:
                import zlib

                raw = zlib.decompress(payload)
                if len(raw) != neblock:
                    raise FormatError("blosc zlib stream wrong size")
                parts.append(raw)
        block = b"".join(parts)
        if shuffled and typesize > 1:
            block = _unshuffle(block, typesize)
        out += block
    if len(out) != nbytes:
        raise FormatError(
            f"blosc chunk decoded to {len(out)} B, header says {nbytes}")
    return bytes(out)


# ---------------------------------------------------------------------------
# Chunk encode
# ---------------------------------------------------------------------------

def compress(data, typesize: int = 4, *, clevel: int = 9,
             shuffle: bool = True, codec: int = CODEC_LZ4,
             blocksize: int = 0) -> bytes:
    """Encode bytes into one blosc1 chunk.

    Defaults mirror OpenVDB's call (io/Compression.cc `bloscCompress`):
    lz4, byte shuffle, typesize 4, blocksize = input size. Returns a chunk
    any conforming c-blosc build decodes.
    """
    data = bytes(data)
    nbytes = len(data)
    if not 0 < typesize <= MAX_TYPESIZE:
        typesize = 1  # c-blosc: oversized typesizes degrade to 1
    if codec not in (CODEC_LZ4, CODEC_ZLIB):
        raise FormatError(f"unsupported blosc write codec {codec}")

    def _memcpyed() -> bytes:
        head = HEADER.pack(VERSION_FORMAT, VERSION_LZ4,
                           FLAG_MEMCPYED, typesize, nbytes, blocksize or nbytes,
                           nbytes + MAX_OVERHEAD)
        return head + data

    if nbytes == 0:
        return HEADER.pack(VERSION_FORMAT, VERSION_LZ4, FLAG_MEMCPYED,
                           typesize, 0, 0, MAX_OVERHEAD)
    if clevel == 0:
        return _memcpyed()

    if blocksize <= 0:
        blocksize = nbytes
    blocksize = max(typesize, blocksize // typesize * typesize)
    blocksize = min(blocksize, nbytes) if nbytes >= typesize else blocksize

    do_shuffle = shuffle and typesize > 1
    dont_split = not _split_block(codec, typesize, blocksize)
    flags = ((FLAG_BYTE_SHUFFLE if do_shuffle else 0)
             | (FLAG_DONT_SPLIT if dont_split else 0)
             | (codec << 5))

    nblocks = -(-nbytes // blocksize)
    leftover = nbytes % blocksize
    bstarts = [0] * nblocks
    streams = bytearray()
    base = MAX_OVERHEAD + 4 * nblocks
    for bi in range(nblocks):
        off = bi * blocksize
        bsize = leftover if (bi == nblocks - 1 and leftover) else blocksize
        is_leftover = bsize != blocksize
        block = data[off : off + bsize]
        if do_shuffle:
            block = _shuffle(block, typesize)
        nsplits = _nsplits(typesize, bsize, is_leftover, dont_split)
        neblock = bsize // nsplits
        bstarts[bi] = base + len(streams)
        for si in range(nsplits):
            stream = block[si * neblock : (si + 1) * neblock]
            if codec == CODEC_LZ4:
                comp = lz4_compress(stream)
            else:
                import zlib

                comp = zlib.compress(stream, clevel)
            if len(comp) >= neblock:
                streams += struct.pack("<i", neblock)
                streams += stream
            else:
                streams += struct.pack("<i", len(comp))
                streams += comp
    cbytes = base + len(streams)
    if cbytes >= nbytes + MAX_OVERHEAD:
        return _memcpyed()
    head = HEADER.pack(VERSION_FORMAT, VERSION_LZ4, flags, typesize,
                       nbytes, blocksize, cbytes)
    return head + struct.pack(f"<{nblocks}i", *bstarts) + bytes(streams)


# ---------------------------------------------------------------------------
# OpenVDB-flavoured entry points (io/Compression.cc semantics)
# ---------------------------------------------------------------------------

BLOSC_MINIMUM_BYTES = 48  # openvdb: buffers below this are never compressed
BLOSC_PAD_BYTES = 128     # openvdb: buffers below this are zero-padded


def openvdb_compress(raw: bytes):
    """OpenVDB's bloscCompress policy: None for tiny buffers (caller
    stores raw), zero-pad sub-128-B inputs, lz4 + shuffle + typesize 4 +
    one block. Returns the chunk bytes or None when not compressed."""
    n = len(raw)
    if n < BLOSC_MINIMUM_BYTES:
        return None
    if n < BLOSC_PAD_BYTES:
        raw = raw + b"\x00" * (BLOSC_PAD_BYTES - n)
    chunk = compress(raw, typesize=4, clevel=9, shuffle=True,
                     codec=CODEC_LZ4, blocksize=len(raw))
    if len(chunk) >= n:
        return None  # not beneficial; caller stores the raw framing
    return chunk


def openvdb_decompress(chunk: bytes, expected_bytes: int) -> bytes:
    """OpenVDB's bloscDecompress: the chunk may decode to more than
    expected (write-side zero padding); return exactly expected bytes."""
    raw = decompress(chunk)
    if len(raw) < expected_bytes:
        raise FormatError(
            f"blosc payload decodes to {len(raw)} B, need {expected_bytes}")
    return raw[:expected_bytes]
