"""SentencePiece ``.spm``/``.model`` protobuf reader and writer (a copy of
`m3p_tpu/tokenization/spm_reader.py`; the port imports nothing of the JAX
package).

Only the pieces of ``ModelProto`` are read:

    ModelProto { repeated SentencePiece pieces = 1; ... }
    SentencePiece { optional string piece = 1;
                    optional float  score = 2;
                    optional Type   type  = 3;  // default NORMAL }

Piece index == raw model id, which the fairseq offset of ``XLMRTokenizer``
expects.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

# SentencePiece piece types (sentencepiece_model.proto)
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_UNUSED = 5
TYPE_BYTE = 6

#: types that participate in text matching during segmentation
MATCHABLE_TYPES = (TYPE_NORMAL, TYPE_USER_DEFINED)


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in .spm model")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long in .spm model")


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == 1:  # 64-bit
        return pos + 8
    if wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire_type == 5:  # 32-bit
        return pos + 4
    raise ValueError(f"unsupported protobuf wire type {wire_type}")


def _parse_piece(buf: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, TYPE_NORMAL
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # piece
            n, pos = _read_varint(buf, pos)
            piece = buf[pos:pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:  # score (float)
            (score,) = struct.unpack("<f", buf[pos:pos + 4])
            pos += 4
        elif field == 3 and wire == 0:  # type (enum)
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wire)
    return piece, score, ptype


def parse_spm(buf: bytes) -> Tuple[List[str], List[float], List[int]]:
    """Parse a serialized ModelProto -> (pieces, scores, types), proto order."""
    pieces: List[str] = []
    scores: List[float] = []
    types: List[int] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece pieces
            n, pos = _read_varint(buf, pos)
            p, s, t = _parse_piece(buf[pos:pos + n])
            pos += n
            pieces.append(p)
            scores.append(s)
            types.append(t)
        else:
            pos = _skip_field(buf, pos, wire)
    if not pieces:
        raise ValueError("no pieces found — not a SentencePiece model?")
    return pieces, scores, types


def load_spm(path: str) -> Tuple[List[str], List[float], List[int]]:
    with open(path, "rb") as f:
        return parse_spm(f.read())


def looks_like_spm(path: str) -> bool:
    """Heuristic: binary protobuf vs the in-tree TSV vocab format."""
    if path.endswith((".spm", ".model")):
        return True
    try:
        with open(path, "rb") as f:
            head = f.read(64)
    except OSError:
        return False
    if not head:
        return False
    # TSV is UTF-8 text with a tab before the newline; ModelProto starts with
    # tag 0x0a (field 1, length-delimited) and contains no early tab
    if head[0] != 0x0A:
        return False
    try:
        head.decode("utf-8")
    except UnicodeDecodeError:
        return True
    return b"\t" not in head.split(b"\n", 1)[0]


# ---------------------------------------------------------------------------
# writer (test fixtures; lets the trainer export .spm files)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def serialize_spm(pieces: List[str], scores: List[float],
                  types: List[int]) -> bytes:
    """``ModelProto`` bytes holding only the pieces (piece, score, type)."""
    out = bytearray()
    for p, s, t in zip(pieces, scores, types):
        body = bytearray()
        pb = p.encode("utf-8")
        body += b"\x0a" + _varint(len(pb)) + pb          # field 1: piece
        body += b"\x15" + struct.pack("<f", s)            # field 2: score
        body += b"\x18" + _varint(t)                      # field 3: type
        out += b"\x0a" + _varint(len(body)) + bytes(body)  # ModelProto.pieces
    return bytes(out)


def write_spm(path: str, pieces: List[str], scores: List[float],
              types: List[int]) -> None:
    with open(path, "wb") as f:
        f.write(serialize_spm(pieces, scores, types))
