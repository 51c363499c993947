"""The port's wire codec (``repro_torch.fed.wire``) against the JAX package's.

Mirrors tests/test_wire.py on the port, and holds the two codecs to each
other byte for byte:

  * **Golden fixtures** (tests/fixtures/wire/*.bin): each decodes in the
    port to the pinned fields and array digests, re-encodes to the same
    bytes, and reproduces the pinned ridge solve; the reference's decode of
    each, rebuilt as a port frame from its numpy arrays, encodes to the same
    bytes too.
  * **Cross-package encodes**: the same numpy arrays encode to the same
    bytes in both packages, for every frame type, at f32, f64 and bf16, with
    and without the MOMENTS section; each package decodes the other's bytes
    to the same values; frames built from the port's torch statistics equal
    frames built from the reference's JAX statistics. bf16 is encoded here
    by bit arithmetic (no ``ml_dtypes`` in the port) and is pinned against
    ``ml_dtypes``' rounding, NaN, infinities, subnormals and ties included.
  * **Roundtrip identity and mutation fuzzing** as in the reference: every
    truncation, flip, length lie and alien blob is a typed ``WireError``;
    hypothesis fuzzes both codecs on the same bytes and they agree.
"""
import dataclasses
import hashlib
import json
import pathlib
import struct
import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _hypo import hypothesis, st
from repro.core.sufficient_stats import compute_stats as jcompute_stats
from repro.fed import wire as jwire
from repro_torch.core.sufficient_stats import compute_stats
from repro_torch.fed import transport, wire
from repro_torch.fed.protocol import PackedStats

FIXDIR = pathlib.Path(__file__).resolve().parent / "fixtures" / "wire"
EXPECTED = json.loads((FIXDIR / "expected.json").read_text())
DTYPES = ["f32", "f64", "bf16"]


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _arr_digest(a: np.ndarray) -> str:
    return _sha(np.ascontiguousarray(a, dtype="<f8").tobytes())


def _unpack(tri: np.ndarray, d: int) -> np.ndarray:
    low = np.zeros((d, d))
    low[np.tril_indices(d)] = tri
    return low + np.tril(low, -1).T


def _random_stats_frame(mod, rng, d, dtype, client_id="c", yty=None):
    A = rng.standard_normal((2 * d + 1, d))
    return mod.StatsFrame(tri=(A.T @ A)[np.tril_indices(d)],
                          moment=rng.standard_normal(d),
                          count=A.shape[0], dim=d, client_id=client_id,
                          wire_dtype=dtype, yty=yty)


def _frames_equal(a, b) -> bool:
    """Value equality across frame types (arrays compared bit-for-bit)."""
    if type(a).__name__ != type(b).__name__:
        return False
    for f in a.__dataclass_fields__:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            if not (va.dtype == vb.dtype and np.array_equal(va, vb)):
                return False
        elif va != vb:
            return False
    return True


def _as_port(jframe):
    """A reference frame rebuilt as the port's frame from its numpy fields."""
    cls = getattr(wire, type(jframe).__name__)
    return cls(**{f.name: getattr(jframe, f.name)
                  for f in dataclasses.fields(jframe)})


def _both_frames(kind, rng, dtype, yty):
    """The same frame in both packages, from the same numpy arrays."""
    d = 5
    A = rng.standard_normal((2 * d + 1, d))
    tri, mom = (A.T @ A)[np.tril_indices(d)], rng.standard_normal(d)
    kw = {"stats": dict(tri=tri, moment=mom, count=11, dim=d, client_id="s",
                        wire_dtype=dtype, yty=yty),
          "proj": dict(tri=tri, moment=mom, count=11, dim=d, d_orig=9,
                       seed=2**40 + 3, rhash=0xDEADBEEF, client_id="p",
                       wire_dtype=dtype, yty=yty),
          "rff": dict(tri=tri, moment=mom, count=11, dim=d, d_orig=3,
                      seed=17, fhash=0x12345678, lengthscale=1.75,
                      client_id="r", wire_dtype=dtype, yty=yty),
          "delta": dict(A=rng.standard_normal((3, d)),
                        b=rng.standard_normal(3), client_id="rows",
                        wire_dtype=dtype),
          "weights": dict(w=rng.standard_normal(d), sigma=0.25,
                          wire_dtype=dtype)}[kind]
    name = {"stats": "StatsFrame", "proj": "ProjectedFrame", "rff": "RFFFrame",
            "delta": "DeltaRowsFrame", "weights": "WeightsFrame"}[kind]
    return getattr(wire, name)(**kw), getattr(jwire, name)(**kw)


class TestGoldenFrames:
    """The checked-in .bin frames are the layout contract for the port too."""

    @pytest.mark.parametrize("name", sorted(EXPECTED))
    def test_decode_matches_pins(self, name):
        data = (FIXDIR / f"{name}.bin").read_bytes()
        exp = EXPECTED[name]
        assert _sha(data) == exp["sha256"] and len(data) == exp["nbytes"]
        frame = wire.decode_frame(data)
        assert type(frame).__name__ == exp["frame_type"]
        for field in ("dim", "count", "client_id", "d_orig", "seed", "rhash",
                      "fhash", "lengthscale", "yty",
                      "sigma", "op", "ok", "message", "tenant"):
            if field in exp:
                assert getattr(frame, field) == exp[field], field
        if "offers" in exp:
            assert list(frame.offers) == exp["offers"]
        for field in ("tri", "moment", "A", "b", "w"):
            if f"{field}_sha256" in exp:
                assert _arr_digest(getattr(frame, field)) == \
                    exp[f"{field}_sha256"], f"decoded {field} drifted"

    @pytest.mark.parametrize("name", sorted(EXPECTED))
    def test_reencode_byte_identical(self, name):
        data = (FIXDIR / f"{name}.bin").read_bytes()
        assert wire.encode_frame(wire.decode_frame(data)) == data

    @pytest.mark.parametrize("name", sorted(EXPECTED))
    def test_reference_decode_encodes_to_same_bytes(self, name):
        """The reference's decoded numpy fields, handed to the port's frame
        class, encode to the fixture's bytes; both decodes agree."""
        data = (FIXDIR / f"{name}.bin").read_bytes()
        jframe = jwire.decode_frame(data)
        assert wire.encode_frame(_as_port(jframe)) == data
        assert _frames_equal(wire.decode_frame(data), jframe)

    @pytest.mark.parametrize("name", [n for n in sorted(EXPECTED)
                                      if "weights_ref" in EXPECTED[n]])
    def test_fused_solve_pinned(self, name):
        exp = EXPECTED[name]
        frame = wire.decode_frame((FIXDIR / f"{name}.bin").read_bytes())
        if hasattr(frame, "tri"):
            G = _unpack(frame.tri.astype("<f8"), frame.dim)
            h = frame.moment.astype("<f8")
        else:
            A = frame.A.astype("<f8")
            G, h = A.T @ A, A.T @ frame.b.astype("<f8")
        w = np.linalg.solve(G + exp["sigma_ref"] * np.eye(G.shape[0]), h)
        np.testing.assert_allclose(w, np.asarray(exp["weights_ref"]),
                                   rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("name", ["stats_f32", "stats_f64", "stats_bf16",
                                      "stats_f32_moments", "proj_bf16",
                                      "rff_f32_moments"])
    def test_to_packed_is_the_decoded_arrays(self, name):
        """``to_packed`` puts the decoded arrays, bit for bit, into the
        port's ``PackedStats``; truncated to float32, as a float32 pool
        admits them, it unpacks to the reference's statistics (whose
        ``asarray`` lands every array in float32)."""
        data = (FIXDIR / f"{name}.bin").read_bytes()
        frame = wire.decode_frame(data)
        p = frame.to_packed("cpu")
        assert p.tri.dtype == torch.from_numpy(frame.tri).dtype
        np.testing.assert_array_equal(p.tri.numpy(), frame.tri)
        np.testing.assert_array_equal(p.moment.numpy(), frame.moment)
        s = frame.to_packed("cpu", torch.float32).unpack()
        js = jwire.decode_frame(data).to_packed().unpack()
        assert s.dim == js.dim and int(s.count) == int(js.count)
        for got, want in ((s.gram, js.gram), (s.moment, js.moment)):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (s.yty is None) == (js.yty is None)
        if s.yty is not None:
            assert float(s.yty) == float(js.yty)

    def test_golden_covers_every_frame_type_and_dtype(self):
        types = {e["frame_type"] for e in EXPECTED.values()}
        assert types == {"Hello", "StatsFrame", "ProjectedFrame",
                         "RFFFrame", "DeltaRowsFrame", "ControlFrame",
                         "SolveFrame", "WeightsFrame", "AckFrame"}
        assert {e["wire_dtype"] for e in EXPECTED.values()
                if e["frame_type"] == "StatsFrame"} == set(DTYPES)


class TestCrossPackageBytes:
    @pytest.mark.parametrize("kind,yty", [
        ("stats", None), ("proj", None), ("rff", None), ("delta", None),
        ("weights", None), ("stats", 3.0 + 2.0 ** -40),
        ("proj", 3.0 + 2.0 ** -40), ("rff", 3.0 + 2.0 ** -40)])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_same_arrays_same_bytes(self, kind, dtype, yty):
        f, jf = _both_frames(kind, np.random.default_rng(len(kind)), dtype,
                             yty)
        data = wire.encode_frame(f, dtype=dtype)
        assert data == jwire.encode_frame(jf, dtype=dtype)
        assert _frames_equal(wire.decode_frame(data), jwire.decode_frame(data))

    @pytest.mark.parametrize("name,args,kw", [
        ("Hello", ("t", ("f32", "bf16")), {}),
        ("ControlFrame", ("drop", "c9"), {}),
        ("ControlFrame", ("restore", ""), {}), ("SolveFrame", (1e-3,), {}),
        ("AckFrame", (True, "ok"), {}),
        ("AckFrame", (True, "dup"), {"duplicate": True}),
        ("AckFrame", (False, "nope — unicode"), {}),
        ("AckFrame", (False, "transient"), {"retryable": True}),
    ])
    def test_scalar_frames_same_bytes(self, name, args, kw):
        data = wire.encode_frame(getattr(wire, name)(*args, **kw))
        assert data == jwire.encode_frame(getattr(jwire, name)(*args, **kw))
        assert _frames_equal(wire.decode_frame(data), jwire.decode_frame(data))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                       torch.bfloat16])
    @pytest.mark.parametrize("moments", [False, True])
    def test_from_stats_of_torch_equals_reference(self, dtype, moments):
        """A STATS frame from the port's torch statistics is the reference's
        frame from the same statistics as JAX arrays, byte for byte."""
        rng = np.random.default_rng(17)
        A = rng.integers(-3, 4, (12, 4)).astype(np.float32)
        b = rng.integers(-3, 4, 12).astype(np.float32)
        s = compute_stats(torch.from_numpy(A), torch.from_numpy(b))
        s = type(s)(s.gram.to(dtype), s.moment.to(dtype), s.count,
                    yty=s.yty.to(dtype))
        js = jcompute_stats(jnp.asarray(A), jnp.asarray(b))
        jdt = {torch.float32: jnp.float32, torch.float64: np.float64,
               torch.bfloat16: jnp.bfloat16}[dtype]
        jframe = jwire.StatsFrame.from_stats(js, client_id="c", moments=moments)
        jframe = dataclasses.replace(
            jframe, tri=np.asarray(jframe.tri).astype(jdt),
            moment=np.asarray(jframe.moment).astype(jdt),
            wire_dtype=wire.dtype_name(dtype))
        frame = wire.StatsFrame.from_stats(s, client_id="c", moments=moments)
        assert frame.wire_dtype == wire.dtype_name(dtype)
        assert wire.encode_frame(frame) == jwire.encode_frame(jframe)

    def test_from_packed_checks_the_triangle(self):
        p = PackedStats(torch.zeros(5), torch.zeros(2), torch.tensor(1), 2)
        with pytest.raises(wire.PayloadError):
            wire.StatsFrame.from_packed(p)
        p = PackedStats(torch.zeros(6), torch.zeros(3), torch.tensor(1), 2)
        with pytest.raises(wire.PayloadError, match="declares"):
            wire.StatsFrame.from_packed(p)


class TestBf16:
    """bf16 without ``ml_dtypes``: round to nearest even by bit arithmetic."""

    @staticmethod
    def _edges():
        bits = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                         0x7FC00000, 0xFFC00001, 0x7F800001, 0x00000001,
                         0x807FFFFF, 0x3F808000, 0x3F818000, 0x3F80FFFF,
                         0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0x0000FFFF,
                         0x00008000, 0x00018000], np.uint32)
        return bits.view(np.float32)

    @pytest.mark.parametrize("source", ["edges", "normal", "bits"])
    def test_bits_equal_ml_dtypes(self, source):
        rng = np.random.default_rng(3)
        x = {"edges": self._edges(),
             "normal": rng.standard_normal(4096).astype(np.float32) * 1e3,
             "bits": rng.integers(0, 2**32, 4096, dtype=np.uint64)
             .astype(np.uint32).view(np.float32)}[source]
        with np.errstate(invalid="ignore"):
            want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(wire._bf16_bits(x), want)

    def test_float64_rounds_through_float32(self):
        """float64 input rounds as the reference's cast does: to float32
        first (values a hair above a bf16 tie fall back onto it)."""
        tie = 1.0 + 2.0 ** -8
        x = np.concatenate([np.random.default_rng(4).standard_normal(2048) * 7,
                            [tie + 2.0 ** -40, tie - 2.0 ** -40, -tie - 2.0 ** -30]])
        np.testing.assert_array_equal(
            wire._bf16_bits(x), x.astype(ml_dtypes.bfloat16).view(np.uint16))
        assert wire._bf16_bits(x[-3:]).tolist() == [0x3F80, 0x3F80, 0xBF80]

    def test_upcast_is_exact_embedding(self):
        f = _random_stats_frame(wire, np.random.default_rng(1), 9, "bf16")
        g = wire.decode_frame(wire.encode_frame(f, dtype="bf16"))
        want = np.asarray(f.tri).astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(g.tri, want)
        assert g.tri.dtype == np.float32 and g.tri.flags.writeable

    def test_torch_bf16_tensor_encodes_its_values(self):
        t = torch.randn(10, dtype=torch.float32).to(torch.bfloat16)
        f = wire.WeightsFrame(w=t, sigma=1.0, wire_dtype="bf16")
        g = wire.decode_frame(wire.encode_frame(f))
        np.testing.assert_array_equal(g.w, t.float().numpy())


class TestRoundtrip:
    @pytest.mark.parametrize("d", [1, 2, 5, 17, 64])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_stats_roundtrip(self, d, dtype):
        f = _random_stats_frame(wire, np.random.default_rng(d), d, dtype,
                                client_id=f"client-{d}")
        data = wire.encode_frame(f, dtype=dtype)
        assert len(data) == wire.stats_frame_nbytes(
            d, dtype, client_id=f"client-{d}")
        g = wire.decode_frame(data)
        assert (g.dim, g.count, g.client_id, g.wire_dtype) == \
            (d, f.count, f.client_id, dtype)
        assert wire.encode_frame(g) == data
        assert _frames_equal(wire.decode_frame(wire.encode_frame(g)), g)
        assert g.tri.dtype == np.dtype(
            {"f32": "<f4", "f64": "<f8", "bf16": "<f4"}[dtype])

    @pytest.mark.parametrize("m,d_orig", [(1, 1), (4, 10), (32, 400)])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_projected_roundtrip(self, m, d_orig, dtype):
        rng = np.random.default_rng(m)
        f = wire.ProjectedFrame(
            tri=_random_stats_frame(wire, rng, m, dtype).tri,
            moment=rng.standard_normal(m), count=9, dim=m, d_orig=d_orig,
            seed=int(rng.integers(2**63)), rhash=int(rng.integers(2**32)),
            client_id="p", wire_dtype=dtype)
        data = wire.encode_frame(f, dtype=dtype)
        assert len(data) == wire.projected_frame_nbytes(m, dtype,
                                                        client_id="p")
        g = wire.decode_frame(data)
        assert (g.dim, g.d_orig, g.seed, g.rhash) == \
            (m, d_orig, f.seed, f.rhash)
        assert wire.encode_frame(g) == data

    @pytest.mark.parametrize("D,d_orig", [(1, 1), (4, 10), (64, 8), (12, 12)])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_rff_roundtrip(self, D, d_orig, dtype):
        rng = np.random.default_rng(D * 131 + d_orig)
        f = wire.RFFFrame(
            tri=_random_stats_frame(wire, rng, D, dtype).tri,
            moment=rng.standard_normal(D), count=9, dim=D, d_orig=d_orig,
            seed=int(rng.integers(2**63)), fhash=int(rng.integers(2**32)),
            lengthscale=float(rng.uniform(0.1, 5.0)),
            client_id="rff", wire_dtype=dtype)
        data = wire.encode_frame(f, dtype=dtype)
        assert len(data) == wire.rff_frame_nbytes(D, dtype, client_id="rff")
        g = wire.decode_frame(data)
        assert (g.dim, g.d_orig, g.seed, g.fhash, g.lengthscale) == \
            (D, d_orig, f.seed, f.fhash, f.lengthscale)
        assert wire.encode_frame(g) == data
        assert _frames_equal(wire.decode_frame(wire.encode_frame(g)), g)

    def test_rff_bad_lengthscale_rejected(self):
        f = _random_stats_frame(wire, np.random.default_rng(0), 4, "f32")
        for bad in (0.0, -1.0, float("nan"), float("inf")):
            with pytest.raises(wire.PayloadError):
                wire.encode_frame(wire.RFFFrame(
                    tri=f.tri, moment=f.moment, count=f.count, dim=4,
                    d_orig=8, seed=1, fhash=2, lengthscale=bad))

    @pytest.mark.parametrize("n,d", [(1, 1), (3, 7), (17, 5), (128, 2)])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_delta_roundtrip_ragged(self, n, d, dtype):
        rng = np.random.default_rng(n * 31 + d)
        f = wire.DeltaRowsFrame(A=rng.standard_normal((n, d)),
                                b=rng.standard_normal(n),
                                client_id="rows", wire_dtype=dtype)
        data = wire.encode_frame(f, dtype=dtype)
        assert len(data) == wire.delta_frame_nbytes(n, d, dtype,
                                                    client_id="rows")
        g = wire.decode_frame(data)
        assert g.A.shape == (n, d) and g.b.shape == (n,)
        assert wire.encode_frame(g) == data

    def test_tensor_fields_encode_as_their_host_values(self):
        """Frames accept the port's tensors (moved to the host once)."""
        A = torch.randn(4, 3, dtype=torch.float64)
        b = torch.randn(4, dtype=torch.float64)
        f = wire.DeltaRowsFrame(A=A, b=b, wire_dtype="f64")
        g = wire.DeltaRowsFrame(A=A.numpy(), b=b.numpy(), wire_dtype="f64")
        assert wire.encode_frame(f) == wire.encode_frame(g)

    @pytest.mark.parametrize("frame", [
        wire.Hello("t", ("f32", "bf16")),
        wire.ControlFrame("drop", "c9"),
        wire.ControlFrame("restore", ""),
        wire.SolveFrame(1e-3),
        wire.AckFrame(True, "ok"),
        wire.AckFrame(False, "nope — unicode too"),
    ], ids=lambda f: type(f).__name__)
    def test_scalar_frames_roundtrip(self, frame):
        data = wire.encode_frame(frame)
        assert _frames_equal(wire.decode_frame(data), frame)
        assert wire.encode_frame(wire.decode_frame(data)) == data

    def test_tri_length_consistency_helpers(self):
        from repro_torch.kernels.ops import tri_dim, tri_len

        for d in (1, 2, 3, 10, 100):
            assert tri_dim(tri_len(d)) == d
        with pytest.raises(ValueError):
            tri_dim(4)

    @pytest.mark.parametrize("dt,name", [
        (torch.float32, "f32"), (torch.float64, "f64"),
        (torch.bfloat16, "bf16"), (np.float32, "f32"), ("float64", "f64")])
    def test_dtype_names(self, dt, name):
        assert wire.dtype_name(dt) == name

    @pytest.mark.parametrize("dt", [torch.float16, torch.int32, np.uint16,
                                    np.int64])
    def test_dtype_without_encoding_is_typed(self, dt):
        with pytest.raises(wire.BadDtype):
            wire.dtype_name(dt)

    def test_helpers_match_reference(self):
        R = np.random.default_rng(8).standard_normal((7, 3)).astype(np.float32)
        assert wire.projection_hash(R) == jwire.projection_hash(R)
        assert wire.projection_hash(torch.from_numpy(R)) == \
            jwire.projection_hash(R)
        assert wire.relay_client_id("r1", 7) == jwire.relay_client_id("r1", 7)
        assert wire.is_relay_client("relay:x#00000001")
        assert not wire.is_relay_client(7)
        with pytest.raises(wire.PayloadError):
            wire.relay_client_id("a#b", 1)
        p = PackedStats.pack(compute_stats(torch.randn(5, 4),
                                           torch.randn(5)))
        jp = jwire.StatsFrame(tri=p.tri.numpy(), moment=p.moment.numpy(),
                              count=5, dim=4)
        for kind in ("tri", "proj", "rff"):
            assert wire.encoded_nbytes(p, frame=kind, client_id="c") == \
                jwire.encoded_nbytes(jp, frame=kind, client_id="c")


def _reseal(body: bytes) -> bytes:
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def _with_payload(data: bytes, payload: bytes) -> bytes:
    hdr = bytearray(data[:wire.HEADER_BYTES])
    hdr[8:12] = struct.pack("<I", len(payload))
    return _reseal(bytes(hdr) + payload)


class TestMoments:
    def _frames(self, yty):
        base = _random_stats_frame(wire, np.random.default_rng(99), 5, "f32")
        return [
            wire.StatsFrame(tri=base.tri, moment=base.moment, count=11,
                            dim=5, client_id="m", wire_dtype="f32", yty=yty),
            wire.ProjectedFrame(tri=base.tri, moment=base.moment, count=11,
                                dim=5, d_orig=9, seed=3, rhash=77,
                                client_id="m", wire_dtype="f32", yty=yty),
            wire.RFFFrame(tri=base.tri, moment=base.moment, count=11,
                          dim=5, d_orig=9, seed=3, fhash=77, lengthscale=2.0,
                          client_id="m", wire_dtype="f32", yty=yty),
        ]

    def test_moments_roundtrip_exact_f64(self):
        yty = 1.0 + 2.0 ** -40
        nbytes = {wire.StatsFrame: wire.stats_frame_nbytes,
                  wire.ProjectedFrame: wire.projected_frame_nbytes,
                  wire.RFFFrame: wire.rff_frame_nbytes}
        for f in self._frames(yty):
            data = wire.encode_frame(f)
            assert len(data) == nbytes[type(f)](5, "f32", client_id="m",
                                                moments=True)
            g = wire.decode_frame(data)
            assert g.yty == yty
            assert wire.encode_frame(g) == data

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_moments_dtype_invariant(self, dtype):
        f = _random_stats_frame(wire, np.random.default_rng(7), 4, dtype,
                                yty=0.1)
        assert wire.decode_frame(wire.encode_frame(f, dtype=dtype)).yty == 0.1

    def test_absent_moments_is_legacy_bytes(self):
        f = _random_stats_frame(wire, np.random.default_rng(3), 6, "f32")
        assert len(wire.encode_frame(f)) == wire.stats_frame_nbytes(
            6, "f32", client_id="c") == wire.stats_frame_nbytes(
            6, "f32", client_id="c",
            moments=True) - wire.MOMENTS_SECTION_BYTES

    def test_nonfinite_yty_rejected_on_encode(self):
        for bad in (float("nan"), float("inf"), float("-inf")):
            for f in self._frames(bad):
                with pytest.raises(wire.PayloadError):
                    wire.encode_frame(f)

    def test_nonfinite_yty_rejected_on_decode(self):
        for f in self._frames(4.25):
            data = wire.encode_frame(f)
            payload = data[wire.HEADER_BYTES:-4]
            evil = payload[:-8] + struct.pack("<d", float("nan"))
            with pytest.raises(wire.PayloadError):
                wire.decode_frame(_with_payload(data, evil))

    def test_partial_moments_section_rejected(self):
        for f in self._frames(4.25):
            data = wire.encode_frame(f)
            payload = data[wire.HEADER_BYTES:-4]
            for cut in (1, 4, 7):
                with pytest.raises(wire.WireError):
                    wire.decode_frame(_with_payload(data, payload[:-cut]))
            with pytest.raises(wire.WireError):
                wire.decode_frame(_with_payload(data, payload + b"\x00" * 3))

    def test_from_stats_moments_flag(self):
        rng = np.random.default_rng(17)
        s = compute_stats(torch.from_numpy(rng.standard_normal((12, 4))
                                           .astype(np.float32)),
                          torch.from_numpy(rng.standard_normal(12)
                                           .astype(np.float32)))
        legacy = wire.StatsFrame.from_stats(s, client_id="c")
        carried = wire.StatsFrame.from_stats(s, client_id="c", moments=True)
        assert legacy.yty is None and carried.yty == float(s.yty)
        assert len(wire.encode_frame(carried)) == \
            len(wire.encode_frame(legacy)) + wire.MOMENTS_SECTION_BYTES


class TestNegotiation:
    def test_server_prefers_widest(self):
        assert wire.negotiate(("f32", "bf16", "f64")) == "f64"
        assert wire.negotiate(("bf16", "f32")) == "f32"
        assert wire.negotiate(("bf16",)) == "bf16"

    def test_unknown_offers_ignored(self):
        assert wire.negotiate(("f16", "posit8", "f32")) == "f32"

    def test_empty_intersection_is_typed(self):
        with pytest.raises(wire.NegotiationError):
            wire.negotiate(("f16",))
        with pytest.raises(wire.NegotiationError):
            wire.negotiate((), preference=("f32",))

    def test_custom_policy(self):
        assert wire.negotiate(("f64", "bf16"),
                              preference=("bf16", "f32")) == "bf16"

    @pytest.mark.parametrize("dtype,first", [(torch.float32, "f32"),
                                             (torch.float64, "f64")])
    def test_server_default_matches_container_width(self, dtype, first):
        """The policy follows the pool's container (the reference's x64
        switch): a float32 pool never prefers f64, but f64-only clients
        still negotiate."""
        pref = transport.default_dtype_preference(dtype)
        assert pref[0] == first and set(pref) == set(DTYPES)
        if dtype == torch.float32:
            from repro.fed import transport as jtransport

            assert pref == jtransport.default_dtype_preference()

    def test_future_dtype_offer_interoperates(self):
        good = wire.encode_frame(wire.Hello("t", ("f32",)))
        tenant = "t".encode()
        payload = struct.pack("<B", 2) + bytes([9, 1]) + \
            struct.pack("<H", len(tenant)) + tenant
        data = _reseal(good[:8] + struct.pack("<I", len(payload)) + payload)
        frame = wire.decode_frame(data)
        assert frame.offers == ("unknown:9", "f32")
        assert wire.encode_frame(frame) == data
        assert wire.negotiate(frame.offers) == "f32"
        with pytest.raises(wire.NegotiationError):
            wire.negotiate(("unknown:9",))


def _good_frames():
    rng = np.random.default_rng(7)
    return [
        wire.encode_frame(_random_stats_frame(wire, rng, 6, "f32"),
                          dtype="f32"),
        wire.encode_frame(_random_stats_frame(wire, rng, 4, "bf16"),
                          dtype="bf16"),
        wire.encode_frame(wire.DeltaRowsFrame(
            A=rng.standard_normal((3, 5)), b=rng.standard_normal(3)),
            dtype="f64"),
        wire.encode_frame(wire.Hello("t", ("f64", "f32"))),
        wire.encode_frame(wire.ControlFrame("drop", "x")),
        wire.encode_frame(wire.SolveFrame(0.5)),
        wire.encode_frame(wire.AckFrame(False, "err")),
    ]


def _assert_rejected_or_identical(mutant: bytes, original: bytes):
    try:
        frame = wire.decode_frame(bytes(mutant))
    except wire.WireError:
        return
    assert wire.encode_frame(frame) == original


class TestMutationFuzz:
    @pytest.mark.parametrize("fidx", range(7))
    def test_every_truncation_rejected(self, fidx):
        data = _good_frames()[fidx]
        for cut in range(len(data)):
            with pytest.raises(wire.WireError):
                wire.decode_frame(data[:cut])

    @pytest.mark.parametrize("fidx", range(7))
    def test_seeded_byte_flips_rejected(self, fidx):
        data = _good_frames()[fidx]
        rng = np.random.default_rng(1000 + fidx)
        for _ in range(300):
            mutant = bytearray(data)
            mutant[int(rng.integers(len(data)))] ^= 1 << int(rng.integers(8))
            with pytest.raises(wire.WireError):
                wire.decode_frame(bytes(mutant))

    @pytest.mark.parametrize("fidx", range(7))
    def test_multibyte_flips_never_crash(self, fidx):
        data = _good_frames()[fidx]
        rng = np.random.default_rng(2000 + fidx)
        for _ in range(300):
            mutant = bytearray(data)
            for pos in rng.integers(len(data), size=int(rng.integers(2, 9))):
                mutant[int(pos)] = int(rng.integers(256))
            _assert_rejected_or_identical(bytes(mutant), data)

    def test_length_prefix_lies(self):
        data = _good_frames()[0]
        true_plen = len(data) - wire.OVERHEAD_BYTES
        for lie in (0, 1, true_plen - 1, true_plen + 1, true_plen + 1000,
                    2**31 - 1, 2**32 - 1):
            mutant = bytearray(data)
            mutant[8:12] = int(lie).to_bytes(4, "little")
            with pytest.raises(wire.WireError):
                wire.decode_frame(bytes(mutant))
        mutant = bytearray(data[:wire.HEADER_BYTES])
        mutant[8:12] = (wire.MAX_PAYLOAD_BYTES + 1).to_bytes(4, "little")
        with pytest.raises(wire.BadLength):
            wire.frame_total_length(bytes(mutant))

    def test_payload_bound_kept(self):
        """A d 4096 f32 STATS frame fits under the 2^28 cap; the cap stays
        the reference's."""
        assert wire.MAX_PAYLOAD_BYTES == jwire.MAX_PAYLOAD_BYTES == 1 << 28
        assert wire.stats_frame_nbytes(4096, "f32") == 33_579_038
        assert wire.stats_frame_nbytes(4096, "f32") < wire.MAX_PAYLOAD_BYTES

    def test_trailing_garbage_rejected(self):
        data = _good_frames()[0]
        with pytest.raises(wire.BadLength):
            wire.decode_frame(data + b"\x00")
        with pytest.raises(wire.BadLength):
            wire.decode_frame(data + data)

    def test_alien_bytes_rejected(self):
        rng = np.random.default_rng(3)
        for n in (0, 1, 11, 12, 13, 64, 1024):
            blob = rng.integers(256, size=n).astype(np.uint8).tobytes()
            with pytest.raises(wire.WireError):
                wire.decode_frame(blob)
        with pytest.raises(wire.BadMagic):
            wire.decode_frame(b"HTTP/1.1 200 OK\r\n\r\n")

    def test_valid_crc_wrong_dim_rejected(self):
        data = bytearray(_good_frames()[0])
        d = int.from_bytes(data[12:16], "little")
        data[12:16] = (d + 1).to_bytes(4, "little")
        with pytest.raises(wire.PayloadError):
            wire.decode_frame(_reseal(bytes(data[:-4])))

    def test_unknown_frame_type_and_dtype_tags(self):
        data = bytearray(_good_frames()[5])
        for pos, exc in ((5, wire.BadFrameType), (6, wire.BadDtype)):
            mutant = bytearray(data)
            mutant[pos] = 0xEE
            with pytest.raises(exc):
                wire.decode_frame(_reseal(bytes(mutant[:-4])))

    def test_future_version_rejected_typed(self):
        data = bytearray(_good_frames()[5])
        data[4] = wire.VERSION + 1
        with pytest.raises(wire.BadVersion):
            wire.decode_frame(_reseal(bytes(data[:-4])))

    def test_nonpositive_sigma_rejected(self):
        for bad in (0.0, -1.0, float("nan"), float("inf")):
            with pytest.raises(wire.PayloadError):
                wire.encode_frame(wire.SolveFrame(bad))

    @pytest.mark.parametrize("fidx", range(7))
    def test_flips_rejected_with_the_reference_type(self, fidx):
        """Both codecs reject the same damaged bytes with the same typed
        error (or, for the multibyte mutants the CRC misses, decode them to
        the same bytes)."""
        data = _good_frames()[fidx]
        rng = np.random.default_rng(3000 + fidx)
        for _ in range(200):
            mutant = bytearray(data)
            for pos in rng.integers(len(data), size=int(rng.integers(1, 4))):
                mutant[int(pos)] ^= 1 << int(rng.integers(8))
            _assert_same_verdict(bytes(mutant))


def _assert_same_verdict(blob: bytes):
    try:
        got = wire.encode_frame(wire.decode_frame(blob))
    except wire.WireError as e:
        with pytest.raises(jwire.WireError) as je:
            jwire.decode_frame(blob)
        assert type(e).__name__ == type(je.value).__name__
        return
    assert got == jwire.encode_frame(jwire.decode_frame(blob))


class TestHypothesisFuzz:
    @hypothesis.given(st.binary(max_size=512))
    @hypothesis.settings(max_examples=300, deadline=None)
    def test_arbitrary_bytes_always_typed(self, blob):
        try:
            frame = wire.decode_frame(blob)
        except wire.WireError:
            return
        assert wire.encode_frame(frame) == blob

    @hypothesis.given(st.binary(max_size=256))
    @hypothesis.settings(max_examples=200, deadline=None)
    def test_arbitrary_bytes_same_verdict_as_reference(self, blob):
        _assert_same_verdict(blob)

    @hypothesis.given(st.integers(min_value=1, max_value=48),
                      st.sampled_from(DTYPES),
                      st.integers(min_value=0, max_value=2**31),
                      st.text(max_size=20))
    @hypothesis.settings(max_examples=100, deadline=None)
    def test_stats_roundtrip_property(self, d, dtype, seed, cid):
        f = _random_stats_frame(wire, np.random.default_rng(seed), d, dtype,
                                client_id=cid)
        data = wire.encode_frame(f, dtype=dtype)
        assert wire.encode_frame(wire.decode_frame(data)) == data
        jf = _random_stats_frame(jwire, np.random.default_rng(seed), d, dtype,
                                 client_id=cid)
        assert data == jwire.encode_frame(jf, dtype=dtype)
