"""Wire-codec twin: the ten cases of ``tests/test_wire_codec.py`` run
through the reference's codec (``gigapaxos_tpu.modeb.wire``) and the
port's copy (``gigapaxos_tpu_torch.modeb.wire``) on the same seeded inputs.

Tolerance: 0.  Encoded bytes must be equal, each codec must decode the
other's bytes to the same content, and both must refuse the same damaged
buffers.
"""

import struct

import numpy as np
import pytest

from gigapaxos_tpu.modeb import wire as jwire
from gigapaxos_tpu_torch.modeb import wire as twire
from gigapaxos_tpu_torch.net import binbatch as tbinbatch

CODECS = (jwire, twire)


def random_frame(rng, n=None, n_pay=None, W=None):
    n = int(rng.integers(0, 20)) if n is None else n
    W = int(rng.integers(1, 9)) if W is None else W
    n_pay = int(rng.integers(0, 16)) if n_pay is None else n_pay
    gids = rng.integers(0, 1 << 62, n).astype(np.uint64)
    scalars = {f: rng.integers(-5, 100, n).astype(np.int32)
               for f in twire.SCALARS}
    flags = rng.integers(0, 8, n).astype(np.int32)
    rings = {f: rng.integers(-1, 1000, (n, W)).astype(np.int32)
             for f in twire.RINGS}
    bits = {f: rng.random((n, W)) < 0.5 for f in twire.RING_BITS}
    payloads = [(int(rng.integers(-1 << 31, 1 << 31)),
                 bool(rng.random() < 0.5), rng.bytes(int(rng.integers(0, 64))))
                for _ in range(n_pay)]
    return dict(sender_r=int(rng.integers(0, 8)),
                tick=int(rng.integers(0, 1 << 40)), W=W, gids=gids,
                scalars=scalars, flags=flags, rings=rings, ring_bits=bits,
                payloads=payloads, full=bool(rng.random() < 0.2))


def assert_frames_equal(f, kw):
    assert f.sender_r == kw["sender_r"] and f.tick == kw["tick"]
    assert f.W == kw["W"] and f.full == kw["full"]
    assert np.array_equal(f.gids, kw["gids"])
    for k in twire.SCALARS:
        assert np.array_equal(f.scalars[k], kw["scalars"][k]), k
    assert np.array_equal(f.flags, kw["flags"])
    for k in twire.RINGS:
        assert np.array_equal(f.rings[k], kw["rings"][k]), k
    for k in twire.RING_BITS:
        assert np.array_equal(f.ring_bits[k], kw["ring_bits"][k]), k
    assert f.payloads == kw["payloads"]


def encode_both(fn, *args, **kw):
    """Encode with both codecs: equal bytes, returned once."""
    a = getattr(jwire, fn)(*args, **kw)
    b = getattr(twire, fn)(*args, **kw)
    assert a == b, fn
    return b


def test_layout_constants_and_gid_match():
    for name in ("MAGIC", "BATCH_MAGIC", "VERSION", "FLAG_COORD_ACTIVE",
                 "FLAG_COORD_PREPARING", "FLAG_COORD_FAST", "SCALARS",
                 "RINGS", "RING_BITS", "RELAY_MAGIC", "RELAY_VERSION"):
        assert getattr(jwire, name) == getattr(twire, name), name
    for name in ("svc", "g0", "alice", "ümlaut#3", ""):
        assert jwire.gid_of(name) == twire.gid_of(name), name
    bits = np.random.default_rng(3).random((17, 8)) < 0.5
    assert np.array_equal(jwire.pack_bits(bits), twire.pack_bits(bits))
    assert np.array_equal(twire.unpack_bits(twire.pack_bits(bits), 8), bits)


def test_frame_roundtrip_randomized():
    rng = np.random.default_rng(1234)
    for _ in range(40):
        kw = random_frame(rng)
        buf = encode_both("encode_frame", **kw)
        for codec in CODECS:
            assert_frames_equal(codec.decode_frame(buf), kw)


def test_frame_roundtrip_smoke():
    kw = random_frame(np.random.default_rng(7), n=3, n_pay=4, W=4)
    buf = encode_both("encode_frame", **kw)
    for codec in CODECS:
        assert_frames_equal(codec.decode_frame(buf), kw)


def test_v1_interleaved_frames_still_decode():
    rng = np.random.default_rng(99)
    kw = random_frame(rng, n=5, n_pay=6, W=3)
    v2 = encode_both("encode_frame", **kw)
    n, n_pay = len(kw["gids"]), len(kw["payloads"])
    pay_bytes = 9 * n_pay + sum(len(p) for _r, _s, p in kw["payloads"])
    cols = v2[twire._HDR.size: len(v2) - pay_bytes]
    v1 = bytearray(twire._HDR.pack(twire.MAGIC, 1, kw["W"], kw["sender_r"],
                                   kw["tick"], int(kw["full"]), n, n_pay))
    v1 += cols
    for rid, stop, body in kw["payloads"]:
        v1 += twire._PAY.pack(rid, int(stop), len(body))
        v1 += body
    for codec in CODECS:
        assert_frames_equal(codec.decode_frame(bytes(v1)), kw)


def test_frame_rejects_bad_magic_and_version():
    kw = random_frame(np.random.default_rng(5), n=2, n_pay=1)
    buf = bytearray(encode_both("encode_frame", **kw))
    bad_ver = bytearray(buf)
    struct.pack_into("<H", bad_ver, 4, 77)
    for codec in CODECS:
        with pytest.raises(ValueError):
            codec.decode_frame(bytes(b"XXXX" + buf[4:]))
        with pytest.raises(ValueError):
            codec.decode_frame(bytes(bad_ver))


def test_batch_container_roundtrip_randomized():
    rng = np.random.default_rng(42)
    for _ in range(30):
        frames = [rng.bytes(int(rng.integers(0, 200)))
                  for _ in range(int(rng.integers(0, 12)))]
        buf = encode_both("encode_frames", frames)
        assert buf[:4] == twire.BATCH_MAGIC
        for codec in CODECS:
            assert codec.decode_frames(buf) == frames
    frames = [b"a", b"", b"ccc"]
    buf = encode_both("encode_frames", frames, magic=b"GPXD")
    for codec in CODECS:
        assert codec.decode_frames(buf, magic=b"GPXD") == frames
        with pytest.raises(ValueError):
            codec.decode_frames(buf)


def test_batch_container_rejects_truncation():
    buf = encode_both("encode_frames", [b"hello", b"world!"])
    for codec in CODECS:
        with pytest.raises(ValueError):
            codec.decode_frames(buf[:-1])
        with pytest.raises(ValueError):
            codec.decode_frames(buf + b"x")


def random_relay_items(rng, n=None):
    n = int(rng.integers(0, 24)) if n is None else n
    return [(int(rng.integers(-1 << 31, 1 << 31)), bool(rng.random() < 0.5),
             rng.bytes(int(rng.integers(0, 96)))) for _ in range(n)]


def test_relay_roundtrip_randomized():
    rng = np.random.default_rng(2024)
    for _ in range(40):
        groups, flat = [], []
        for _g in range(int(rng.integers(1, 4))):
            items = random_relay_items(rng)
            flat.extend(items)
            ga, gb = jwire.relay_group(items), twire.relay_group(items)
            for x, y in zip(ga[:3], gb[:3]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            assert ga[3] == gb[3]
            groups.append(gb)
        sr, tick = int(rng.integers(0, 8)), int(rng.integers(0, 1 << 40))
        buf = encode_both("encode_relay", sr, tick, 123.5, groups)
        assert buf[:4] == twire.RELAY_MAGIC
        for codec in CODECS:
            slab = codec.decode_relay(buf)
            assert slab.sent_s == 123.5
            assert (slab.sender_r, slab.tick) == (sr, tick)
            assert slab.items() == flat


def test_relay_slab_keep_slices_and_reoffsets():
    rng = np.random.default_rng(77)
    for _ in range(40):
        items = random_relay_items(rng, n=int(rng.integers(1, 24)))
        buf = encode_both("encode_relay", 2, 9, 0.0,
                          [twire.relay_group(items)])
        keep = rng.random(len(items)) < 0.6
        kept = [it for it, k in zip(items, keep) if k]
        groups = [codec.slab_keep(codec.decode_relay(buf), keep)
                  for codec in CODECS]
        out = [codec.encode_relay(3, 10, 0.0, [g])
               for codec, g in zip(CODECS, groups)]
        assert out[0] == out[1]
        for codec in CODECS:
            assert codec.decode_relay(out[1]).items() == kept


def test_relay_rejects_bad_magic_version_truncation():
    items = random_relay_items(np.random.default_rng(8), n=5)
    buf = encode_both("encode_relay", 1, 2, 0.0,
                      [twire.relay_group(items)])
    bad_ver = bytearray(buf)
    struct.pack_into("<H", bad_ver, 4, 99)
    for codec in CODECS:
        with pytest.raises(ValueError):
            codec.decode_relay(b"XXXX" + buf[4:])
        with pytest.raises(ValueError):
            codec.decode_relay(bytes(bad_ver))
        with pytest.raises((ValueError, struct.error)):
            codec.decode_relay(buf[:-1])


def test_relay_magic_distinct_from_other_protocols():
    magics = {twire.MAGIC, twire.BATCH_MAGIC, twire.RELAY_MAGIC,
              tbinbatch.REQ_MAGIC, tbinbatch.REQ2_MAGIC,
              tbinbatch.RESP_MAGIC}
    assert len(magics) == 6
