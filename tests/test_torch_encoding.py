"""The port's bufferlist, wire encoding and auth against ceph_tpu's.

Seeded values (numpy) go through both packages: chains and CRCs,
encoded bytes of every type (each side decoding the other's), keyring
files, and the AEAD both ways on each of its two branches (AES-GCM
where pyca/cryptography is installed, the HMAC-SHA256 stream where it
is not, forced here by setting ``AESGCM = None`` in both packages).
"""

import numpy as np
import pytest

from ceph_tpu.core import auth as RA
from ceph_tpu.core import buffer as RB
from ceph_tpu.core import encoding as RE
from ceph_tpu_torch.core import auth as PA
from ceph_tpu_torch.core import buffer as PB
from ceph_tpu_torch.core import encoding as PE


@pytest.fixture(params=["aesgcm", "hmac"])
def branch(request, monkeypatch):
    """Run a test on the AESGCM branch and on the HMAC branch."""
    if request.param == "aesgcm":
        if PA.AESGCM is None or RA.AESGCM is None:
            pytest.skip("pyca/cryptography is not installed")
    else:
        monkeypatch.setattr(PA, "AESGCM", None)
        monkeypatch.setattr(RA, "AESGCM", None)
    return request.param


def _segments(rng, n=7):
    return [rng.integers(0, 256, int(rng.integers(0, 300)),
                         dtype=np.uint8) for _ in range(n)]


# -- bufferlist ---------------------------------------------------------------

def test_bufferlist_operations_match():
    rng = np.random.default_rng(1)
    segs = _segments(rng)
    lists = []
    for mod in (PB, RB):
        bl = mod.BufferList()
        for i, s in enumerate(segs):
            bl.append(s if i % 2 else s.tobytes())
        bl.append_zero(5)
        other = mod.BufferList(b"tail")
        bl.claim_append(other)
        assert len(other) == 0
        lists.append(bl)
    a, b = lists
    assert bytes(a) == bytes(b) and len(a) == len(b)
    assert a.num_buffers == b.num_buffers
    assert np.array_equal(a.to_numpy(), b.to_numpy())
    for off, ln in ((0, 0), (3, 40), (17, len(a) - 17), (len(a) - 1, 1)):
        sa = PB.BufferList().substr_of(a, off, ln)
        sb = RB.BufferList().substr_of(b, off, ln)
        assert bytes(sa) == bytes(sb) == bytes(a)[off:off + ln]
    with pytest.raises(IndexError):
        PB.BufferList().substr_of(a, len(a), 1)
    assert a.hexdump(64) == b.hexdump(64)
    a.rebuild()
    assert a.num_buffers == 1 and a == bytes(b)


def test_bufferlist_crc32c_equals_reference():
    rng = np.random.default_rng(2)
    for trial in range(4):
        segs = _segments(rng, n=1 + trial * 3)
        a, b = PB.BufferList(), RB.BufferList()
        for s in segs:
            a.append(s)
            b.append(s)
        for seed in (0, 0xFFFFFFFF, int(rng.integers(0, 2 ** 32))):
            assert a.crc32c(seed) == b.crc32c(seed)
    assert PB.BufferList(b"123456789").crc32c(0xFFFFFFFF) ^ 0xFFFFFFFF \
        == RB.BufferList(b"123456789").crc32c(0xFFFFFFFF) ^ 0xFFFFFFFF


# -- encoding -----------------------------------------------------------------

def _encode(mod, vals):
    enc = mod.Encoder()
    enc.u8(vals["u8"])
    enc.u16(vals["u16"])
    enc.u32(vals["u32"])
    enc.u64(vals["u64"])
    enc.s32(vals["s32"])
    enc.s64(vals["s64"])
    enc.f64(vals["f64"])
    enc.boolean(vals["bool"])
    enc.blob(vals["blob"])
    enc.string(vals["str"])
    enc.raw(vals["raw"])
    enc.list_of(vals["list"], lambda e, v: e.s64(v))
    enc.map_of(vals["map"], lambda e, k: e.string(k),
               lambda e, v: e.u32(v))
    with enc.struct_block(2, 1):
        enc.u32(vals["u32"])
        enc.string(vals["str"])
    return enc


def _decode(mod, data, raw_len):
    dec = mod.Decoder(data)
    out = {"u8": dec.u8(), "u16": dec.u16(), "u32": dec.u32(),
           "u64": dec.u64(), "s32": dec.s32(), "s64": dec.s64(),
           "f64": dec.f64(), "bool": dec.boolean(), "blob": dec.blob(),
           "str": dec.string(), "raw": dec.raw(raw_len),
           "list": dec.list_of(lambda d: d.s64()),
           "map": dec.map_of(lambda d: d.string(), lambda d: d.u32())}
    with dec.struct_block(2) as blk:
        assert blk.version == 2
        out["block"] = (dec.u32(), dec.string())
        assert not blk.has_more()
    assert dec.remaining() == 0
    return out


@pytest.mark.parametrize("seed", range(6))
def test_encoder_bytes_equal_and_cross_decode(seed):
    rng = np.random.default_rng(seed)
    vals = {
        "u8": int(rng.integers(0, 256)), "u16": int(rng.integers(0, 1 << 16)),
        "u32": int(rng.integers(0, 1 << 32)),
        "u64": int(rng.integers(0, 1 << 63)) * 2 + 1,
        "s32": int(rng.integers(-(1 << 31), 1 << 31)),
        "s64": int(rng.integers(-(1 << 63), 1 << 63)),
        "f64": float(rng.standard_normal() * 1e9),
        "bool": bool(rng.integers(0, 2)),
        "blob": rng.integers(0, 256, int(rng.integers(0, 64)),
                             dtype=np.uint8).tobytes(),
        "str": "".join(chr(int(c)) for c in rng.integers(32, 0x3000, 9)),
        "raw": rng.integers(0, 256, 5, dtype=np.uint8).tobytes(),
        "list": [int(v) for v in rng.integers(-1000, 1000, 4)],
        "map": {f"k{int(v)}": int(v) for v in rng.integers(0, 99, 3)},
    }
    pe, re_ = _encode(PE, vals), _encode(RE, vals)
    assert bytes(pe) == bytes(re_)
    assert bytes(pe.bl()) == bytes(re_.bl())
    want = dict(vals, block=(vals["u32"], vals["str"]))
    assert _decode(PE, bytes(re_), 5) == want
    assert _decode(RE, bytes(pe), 5) == want
    assert _decode(PE, re_.bl(), 5) == want


def test_decoders_refuse_alike():
    enc = RE.Encoder()
    with enc.struct_block(5, 4):
        enc.u32(1)
    for mod in (PE, RE):
        with pytest.raises(mod.DecodeError, match="compat"):
            with mod.Decoder(bytes(enc)).struct_block(3):
                pass
        with pytest.raises(mod.DecodeError):
            mod.Decoder(b"\x01\x02").u32()


def test_newer_encoder_fields_are_skipped():
    enc = PE.Encoder()
    with enc.struct_block(3, 1):
        enc.u32(7)
        enc.string("added in v3")
    enc.u8(9)
    for mod in (PE, RE):
        dec = mod.Decoder(bytes(enc))
        with dec.struct_block(1) as blk:
            assert dec.u32() == 7 and blk.has_more()
        assert dec.u8() == 9


# -- auth ---------------------------------------------------------------------

def _keyring(mod, rng):
    kr = mod.KeyRing()
    for i in range(4):
        secret = rng.integers(0, 256, (16, 24, 32)[i % 3],
                              dtype=np.uint8).tobytes()
        kr.add(f"osd.{i}", mod.CryptoKey(secret, created=1.0),
               caps={"mon": "allow profile osd", "osd": f"allow pool {i}"})
    kr.add("client.admin", mod.CryptoKey(b"\x01" * 16, created=1.0),
           caps={"mon": "allow *"})
    return kr


def test_keyring_files_equal_and_load_across():
    a = _keyring(PA, np.random.default_rng(3))
    b = _keyring(RA, np.random.default_rng(3))
    assert a.dump() == b.dump()
    assert PA.KeyRing.load(b.dump()).dump() == b.dump()
    assert RA.KeyRing.load(a.dump()).dump() == a.dump()
    assert a.entities() == b.entities()
    with pytest.raises(PA.AuthError):
        a.get("osd.99")


def test_crypto_key_round_trip_across_packages(branch):
    rng = np.random.default_rng(4)
    secret = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    pk, rk = PA.CryptoKey(secret), RA.CryptoKey(secret)
    assert pk.to_str() == rk.to_str()
    for n in (0, 1, 15, 16, 1000):
        msg = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for enc, dec, err in ((pk, rk, RA.AuthError),
                              (rk, pk, PA.AuthError)):
            blob = enc.encrypt(msg, aad=b"svc")
            assert dec.decrypt(blob, aad=b"svc") == msg
            tampered = blob[:-1] + bytes([blob[-1] ^ 1])
            for bad, aad in ((tampered, b"svc"), (blob, b"other")):
                with pytest.raises(err):
                    dec.decrypt(bad, aad=aad)
            with pytest.raises(err):
                dec.decrypt(blob[:12])
    assert pk.sign(b"nonce") == rk.sign(b"nonce")
    assert rk.verify(b"nonce", pk.sign(b"nonce"))


def test_tickets_verify_across_packages(branch):
    rng = np.random.default_rng(5)
    svc_secret = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    for server_mod, client_mod in ((PA, RA), (RA, PA)):
        kr = _keyring(server_mod, np.random.default_rng(6))
        server = server_mod.AuthServer(
            kr, {"osd": server_mod.CryptoKey(svc_secret)})
        reply = server.handle_auth_request("osd.1", "osd")
        client_key = client_mod.CryptoKey(kr.get("osd.1").key.secret)
        ticket = client_mod.AuthClient("osd.1", client_key).open_session(
            reply, "osd")
        # the service side is each package in turn
        for mod in (PA, RA):
            verifier = mod.ServiceVerifier(
                "osd", mod.CryptoKey(svc_secret))
            nonce = rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
            ent, session, caps = verifier.verify_authorizer(
                ticket.make_authorizer(nonce), nonce)
            assert (ent, caps) == ("osd.1", "allow pool 1")
            assert session.secret == ticket.session_key.secret
            forged = dict(ticket.make_authorizer(nonce), entity="osd.2")
            with pytest.raises(mod.AuthError, match="mismatch"):
                verifier.verify_authorizer(forged, nonce)
            with pytest.raises(mod.AuthError, match="proof"):
                verifier.verify_authorizer(
                    ticket.make_authorizer(nonce), nonce + b"x")
        with pytest.raises(server_mod.AuthError):
            server.handle_auth_request("osd.1", "mds")


def test_cluster_auth_tickets_across_packages(branch):
    secret = bytes(range(16))
    for mint, check in ((PA, RA), (RA, PA)):
        ticket = mint.ClusterAuth(secret).ticket("mon.0")
        nonce = b"n" * 16
        ent, _session, caps = check.ClusterAuth(secret).verifier() \
            .verify_authorizer(ticket.make_authorizer(nonce), nonce)
        assert (ent, caps) == ("mon.0", "allow *")
        expired = mint.ClusterAuth(secret).ticket("mon.0", ttl=-1.0)
        with pytest.raises(check.AuthError, match="expired"):
            check.ClusterAuth(secret).verifier().verify_authorizer(
                expired.make_authorizer(nonce), nonce)
    kw = PA.ClusterAuth(secret).msgr_kwargs("osd.3")
    assert kw["mode"] == "secure" and callable(kw["session_ticket"])
    assert kw["session_ticket"]().entity == "osd.3"


def test_hmac_branch_is_the_gate_in_both(monkeypatch):
    """Without pyca/cryptography both packages seal with the same
    HMAC-SHA256 stream: one nonce gives one ciphertext."""
    monkeypatch.setattr(PA, "AESGCM", None)
    monkeypatch.setattr(RA, "AESGCM", None)
    nonce, msg = b"\x07" * 12, b"the same frame"
    key = bytes(range(16))
    assert PA.CryptoKey(key)._seal(nonce, msg, b"a") == \
        RA.CryptoKey(key)._seal(nonce, msg, b"a")
