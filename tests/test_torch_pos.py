"""The port's pos.py against the JAX package's: the ten cases of
tests/test_pos.py (the reference's pos.rs tests plus array semantics), each
run on the port's helpers and held equal to the JAX package's on the same
inputs, tolerance 0."""

import numpy as np

from seqrush_tpu import pos as jpos
from seqrush_tpu_torch.pos import (
    decode_bases,
    decr_pos,
    encode_bases,
    flip_orientation,
    handle_flip,
    handle_is_rev,
    handle_node,
    handle_str,
    incr_pos,
    is_rev,
    make_handle,
    make_pos,
    pos_offset,
    rc_byte,
    reverse_complement,
    reverse_complement_codes,
)


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b)) and np.asarray(a).dtype == np.asarray(b).dtype


def test_position_encoding():
    p = make_pos(100, False)
    assert pos_offset(p) == 100 and not is_rev(p)
    p = make_pos(100, True)
    assert pos_offset(p) == 100 and is_rev(p)
    assert _same(p, jpos.make_pos(100, True)) and _same(is_rev(p), jpos.is_rev(p))


def test_position_increment():
    assert pos_offset(incr_pos(make_pos(10, False))) == 11
    assert not is_rev(incr_pos(make_pos(10, False)))
    nxt = incr_pos(make_pos(10, True))
    assert pos_offset(nxt) == 9 and is_rev(nxt)
    for p in (make_pos(10, False), make_pos(10, True), make_pos(0, True)):
        assert _same(incr_pos(p), jpos.incr_pos(p))


def test_position_decrement():
    assert pos_offset(decr_pos(make_pos(10, False))) == 9
    prev = decr_pos(make_pos(10, True))
    assert pos_offset(prev) == 11 and is_rev(prev)
    for p in (make_pos(10, False), make_pos(10, True), make_pos(0, False)):
        assert _same(decr_pos(p), jpos.decr_pos(p))


def test_flip_orientation():
    p = make_pos(50, False)
    r = flip_orientation(p)
    assert pos_offset(r) == 50 and is_rev(r)
    assert flip_orientation(r) == p
    assert _same(r, jpos.flip_orientation(p))


def test_boundary_conditions():
    assert pos_offset(decr_pos(make_pos(0, False))) == 0
    assert pos_offset(incr_pos(make_pos(0, True))) == 0


def test_vectorized_pos():
    rng = np.random.default_rng(0)
    offs = np.arange(10, dtype=np.int64)
    ps = make_pos(offs, np.zeros(10, dtype=bool))
    assert (pos_offset(ps) == offs).all()
    nxt = incr_pos(ps)
    assert (pos_offset(nxt) == offs + 1).all()
    offs = rng.integers(0, 1 << 20, size=64).astype(np.int64)
    rev = rng.integers(0, 2, size=64).astype(bool)
    ps = make_pos(offs, rev)
    assert _same(ps, jpos.make_pos(offs, rev))
    for fn, ref in ((incr_pos, jpos.incr_pos), (decr_pos, jpos.decr_pos), (is_rev, jpos.is_rev),
                    (pos_offset, jpos.pos_offset), (flip_orientation, jpos.flip_orientation)):
        assert _same(fn(ps), ref(ps))


def test_handles():
    h = make_handle(42, False)
    assert handle_node(h) == 42 and not handle_is_rev(h)
    assert handle_is_rev(handle_flip(h))
    assert handle_flip(handle_flip(h)) == h
    hs = make_handle(np.arange(5, dtype=np.int64), np.array([0, 1, 0, 1, 1], bool))
    assert _same(hs, jpos.make_handle(np.arange(5, dtype=np.int64), np.array([0, 1, 0, 1, 1], bool)))
    for fn, ref in ((handle_node, jpos.handle_node), (handle_is_rev, jpos.handle_is_rev),
                    (handle_flip, jpos.handle_flip)):
        assert _same(fn(hs), ref(hs))
    assert [handle_str(x) for x in hs] == [jpos.handle_str(x) for x in hs] == ["0+", "1-", "2+", "3-", "4-"]


def test_reverse_complement():
    assert reverse_complement(b"ATCG").tobytes() == b"CGAT"
    assert reverse_complement(b"AAAA").tobytes() == b"TTTT"
    assert reverse_complement(b"GCTA").tobytes() == b"TAGC"
    assert reverse_complement(b"N").tobytes() == b"N"
    assert [rc_byte(b) for b in range(256)] == [jpos.rc_byte(b) for b in range(256)]
    assert rc_byte(ord("a")) == ord("t")


def test_encode():
    codes = encode_bases(b"ACGTN")
    assert list(codes) == [0, 1, 2, 3, 4]
    # case-sensitive: lowercase keeps raw byte values (reference compares
    # raw bytes, so 'a' never matches 'A')
    lower = encode_bases(b"acgtn")
    assert list(lower) == [ord(c) for c in "acgtn"]
    assert decode_bases(np.arange(6)) == jpos.decode_bases(np.arange(6)) == b"ACGTNX"
    assert decode_bases(codes) == b"ACGTN"


def test_rc_codes_roundtrip():
    codes = encode_bases(b"ACGTNacgtn")
    rc2 = reverse_complement_codes(reverse_complement_codes(codes))
    assert (rc2 == codes).all()
    # code-space RC agrees with byte-space RC
    byte_rc = encode_bases(reverse_complement(b"ACGTNacgtn"))
    assert (reverse_complement_codes(codes) == byte_rc).all()
    assert _same(reverse_complement_codes(codes), jpos.reverse_complement_codes(codes))
