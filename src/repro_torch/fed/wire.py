"""Versioned binary wire protocol for one-shot uploads (the Theorem-4 bytes).

The port's codec speaks the JAX package's protocol byte for byte (the
golden frames in ``tests/fixtures/wire/`` pin it); it differs only at the
edges: frames are built from and unpacked into the port's torch tensors
(``to_packed`` returns a ``repro_torch.fed.PackedStats``), and bf16 is
encoded by bit arithmetic (round to nearest even), not through a numpy
bf16 dtype.

Until statistics cross a process boundary as *bytes*, the paper's whole
communication story (Thm 4's d(d+1)/2 + d floats, §IV-F's O(m^2) projected
payloads, the one-shot-vs-FedAvg ledger) is an in-memory fiction. This module
is the byte layer: a fixed little-endian frame codec with strict validation,
so two processes that only share this file agree bit-for-bit on what an
upload means.

Frame layout (all integers little-endian)::

    offset  size  field
    ------  ----  -----------------------------------------------
    0       4     magic  b"OSRR"
    4       1     protocol version (currently 1)
    5       1     frame type (FT_*)
    6       1     dtype tag (DT_*; scalar encoding of array fields)
    7       1     flags (0 unless defined for the type: ACK status bits,
                  FLAG_CONTINUED chunking on upload types)
    8       4     payload length N (u32)
    12      N     payload (frame-type specific, see the frame classes)
    12+N    4     CRC32 of bytes [0, 12+N)

Frame types:

======================  ====  ==================================================
frame                   type  paper surface
======================  ====  ==================================================
:class:`Hello`          0x01  session open: tenant + client dtype offer; the
                              server replies with the one dtype its policy picks
:class:`StatsFrame`     0x02  Thm-4 upload: packed lower-triangular Gram + moment
:class:`ProjectedFrame` 0x03  §IV-F sketched upload: m-dim stats + (R-seed, R-hash)
:class:`DeltaRowsFrame` 0x04  §VI-C streaming delta: a batch of raw rows
:class:`ControlFrame`   0x05  Thm-8 control plane: client drop / rejoin
:class:`SolveFrame`     0x06  Phase-3 query: weights at sigma
:class:`WeightsFrame`   0x07  server download: the fused ridge solution
:class:`AckFrame`       0x08  server status reply
:class:`RFFFrame`       0x09  §IV-F RFF upload: D-dim stats + (W/c-seed,
                              lengthscale, map-hash)
======================  ====  ==================================================

STATS / PROJ / RFF payloads may carry an optional trailing MOMENTS section
(one f64: yty = Σ b², the residual second moment that closes the federated
inference algebra). Presence is inferred from payload length, never a flags
bit, so pre-moments encodings are byte-identical and pre-moments decoders
reject moments-bearing frames with a typed trailing-bytes error.

Dtype negotiation: a client *offers* a set of scalar encodings (f32 / f64 /
bf16) in its HELLO; the server picks one by policy (:func:`negotiate`) and
every array field on that session is encoded with it. :func:`decode_frame`
upcasts deterministically (bf16 -> f32, f32/f64 identity); server-side
fusion is then bit-exact with respect to the dtype-quantized statistics
that were actually on the wire whenever the negotiated dtype embeds in the
server's container dtype — bf16 and f32 on a float32 pool, all three on a
float64 pool. The server's default policy
(``transport.default_dtype_preference``) therefore never *prefers* a wire
dtype wider than its container (an f64 session against an f32 container is
only negotiated for f64-only clients, and is truncated at admission).
WEIGHTS downloads are encoded at the solve's own dtype, not the session's.

Validation is strict and *typed*: truncated, corrupt, inconsistent, or alien
bytes raise a :class:`WireError` subclass — never a crash, never a silent
mis-decode (the CRC covers header + payload, and every variable-size field is
bounds-checked before it is read). The fuzz suite in tests/test_wire.py pins
this contract.

The triangular pack codec itself is shared with the in-process path
(``kernels.ops.pack_lower`` / ``unpack_lower`` via ``fed.PackedStats``);
this module only moves the packed representation, it never re-derives it.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np
import torch

from repro_torch.kernels.ops import tri_dim, tri_len

MAGIC = b"OSRR"
VERSION = 1
_HEADER = struct.Struct("<4sBBBBI")
HEADER_BYTES = _HEADER.size          # 12
TRAILER_BYTES = 4                    # CRC32
OVERHEAD_BYTES = HEADER_BYTES + TRAILER_BYTES
MAX_PAYLOAD_BYTES = 1 << 28          # reject length-prefix lies before allocating
MAX_DIM = 1 << 20
MAX_ROWS = 1 << 24
# The in-process containers carry counts as int32 (SuffStats.count); a wire
# count the server could not represent is a typed rejection, not an overflow
# deep inside admission.
MAX_COUNT = 2**31 - 1

FT_HELLO, FT_STATS, FT_PROJ, FT_DELTA = 0x01, 0x02, 0x03, 0x04
FT_CONTROL, FT_SOLVE, FT_WEIGHTS, FT_ACK = 0x05, 0x06, 0x07, 0x08
FT_RFF = 0x09

# Header flags bits defined for ACK frames only (append-only extension: every
# other frame type still requires flags == 0, so pre-existing encodings of
# all frame types — including old ACKs — are byte-identical).
ACK_FLAG_RETRYABLE = 0x01    # transient rejection: safe to re-send, dedup'd
ACK_FLAG_DUPLICATE = 0x02    # upload was already fused; nothing applied twice
_ACK_FLAGS_MASK = ACK_FLAG_RETRYABLE | ACK_FLAG_DUPLICATE

# Continuation bit for UPLOAD frame types (same append-only precedent as the
# ACK bits): a frame with this bit set is one CHUNK of a larger logical
# frame's payload — more chunks of the same type follow on the same session;
# the chunk whose flags byte is 0 terminates the sequence and the
# concatenated payloads decode as one ordinary frame (:func:`join_chunks`
# reconstructs bytes identical to the unchunked :func:`encode_frame`
# output, so dedup keys are chunking-invariant). Single-frame encodings
# still carry flags == 0, so every pre-existing fixture is untouched; a v1
# peer that predates this bit rejects chunks with the reserved-flags error
# instead of mis-decoding them.
FLAG_CONTINUED = 0x01
CHUNKABLE_FRAME_TYPES = frozenset({FT_STATS, FT_PROJ, FT_DELTA, FT_RFF})
# A reassembled logical payload may legitimately exceed the per-frame cap
# (that cap exists to stop length-prefix lies, and chunking is the sanctioned
# way past it) — but never the u32 length field itself. Journal replay uses
# the same relaxed cap, since journaled records are reassembled frames.
MAX_REASSEMBLED_BYTES = (1 << 32) - 1

# -- dtype registry ----------------------------------------------------------

DTYPE_TAGS = {"f32": 1, "f64": 2, "bf16": 3}
_TAG_NAMES = {v: k for k, v in DTYPE_TAGS.items()}
# Each wire dtype's scalar layout: bf16 travels as the top half of a float32
# (a little-endian u16), encoded and decoded by bit arithmetic.
_WIRE_NP = {"f32": np.dtype("<f4"), "f64": np.dtype("<f8"),
            "bf16": np.dtype("<u2")}
_TORCH_NAMES = {torch.float32: "f32", torch.float64: "f64",
                torch.bfloat16: "bf16"}
_NUMPY_NAMES = {np.dtype("<f4"): "f32", np.dtype("<f8"): "f64"}
# Deterministic decode upcast: bf16 embeds exactly in f32, so fusing decoded
# uploads in f32 is bit-exact w.r.t. the quantized bytes on the wire.
DECODES_TO = {"f32": "f32", "f64": "f64", "bf16": "f32"}
# Server-side negotiation default: widest common precision wins.
DEFAULT_PREFERENCE = ("f64", "f32", "bf16")


def dtype_name(dt) -> str:
    """Wire name for a torch or numpy float dtype; WireError if it has no
    wire encoding."""
    name = (_TORCH_NAMES.get(dt) if isinstance(dt, torch.dtype)
            else _NUMPY_NAMES.get(np.dtype(dt)))
    if name is None:
        raise BadDtype(f"dtype {dt} has no wire encoding "
                       f"(supported: {sorted(_WIRE_NP)})")
    return name


def _wire_name_or_f32(dt) -> str:
    """A payload's own wire dtype, f32 for a dtype without one."""
    try:
        return dtype_name(dt)
    except BadDtype:
        return "f32"


def host_array(x) -> np.ndarray:
    """An array field on the host: a tensor moves once (bf16 widened to
    float32, exactly); numpy-convertible input passes through."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def wire_itemsize(name: str) -> int:
    if name not in _WIRE_NP:
        raise BadDtype(f"unknown wire dtype {name!r}")
    return _WIRE_NP[name].itemsize


def negotiate(offers, *, preference=DEFAULT_PREFERENCE) -> str:
    """Server dtype policy: the first *preferred* dtype the client offered.

    Unknown offer names are ignored (a newer client may offer encodings this
    version does not know); an empty intersection is a typed failure.
    """
    offered = {o for o in offers if o in DTYPE_TAGS}
    for name in preference:
        if name in offered:
            return name
    raise NegotiationError(
        f"no common dtype: client offered {tuple(offers)}, "
        f"server accepts {tuple(preference)}")


# -- typed errors ------------------------------------------------------------

class WireError(ValueError):
    """Base for every frame-level rejection (always typed, never a crash)."""


class TruncatedFrame(WireError):
    """Fewer bytes than the header/declared length requires."""


class BadMagic(WireError):
    """Alien bytes: the magic prefix is wrong."""


class BadVersion(WireError):
    """Unsupported protocol version."""


class BadFrameType(WireError):
    """Unknown frame-type byte."""


class BadDtype(WireError):
    """Unknown or unsupported dtype tag."""


class BadLength(WireError):
    """Length prefix lies: over-long, over-cap, or trailing bytes."""


class ChecksumMismatch(WireError):
    """CRC32 over header+payload does not match the trailer."""


class PayloadError(WireError):
    """Payload fields are internally inconsistent (d/m/n, bounds, reserved)."""


class NegotiationError(WireError):
    """Client offer and server policy share no dtype."""


class ContinuationChunk(WireError):
    """The buffer holds one valid chunk of a chunked upload, not a whole
    frame — route it to reassembly (:func:`chunk_parts` / :func:`join_chunks`)
    instead of decoding it standalone."""


# -- frame classes -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Hello:
    """Session open (client->server) / dtype choice (server->client).

    Payload: u8 n_offers, n_offers dtype tags, u16 tenant_len, tenant utf-8.
    The server's reply is a Hello whose single offer is the negotiated dtype.
    """

    tenant: str = "default"
    offers: tuple[str, ...] = ("f32",)


@dataclasses.dataclass(frozen=True, eq=False)
class StatsFrame:
    """Thm-4 upload: the packed d(d+1)/2 Gram triangle + d-float moment.

    Payload: u32 d, u64 count, u16 id_len, client id utf-8,
    tri (d(d+1)/2 scalars), moment (d scalars)
    [, MOMENTS section: f64 yty — see :func:`_maybe_yty`].
    """

    tri: np.ndarray
    moment: np.ndarray
    count: int
    dim: int
    client_id: str = ""
    wire_dtype: str = "f32"
    yty: float | None = None

    @classmethod
    def from_packed(cls, packed, client_id: str = "", *,
                    moments: bool = False) -> "StatsFrame":
        """From a ``fed.PackedStats`` (or anything shaped like one); its
        tensors move to the host once, here.

        ``moments=True`` carries the payload's residual second moment (yty)
        in the trailing MOMENTS section when it has one; the default keeps
        the encoding byte-identical to the pre-moments protocol (an old
        server rejects unknown trailing bytes with a typed error).
        """
        tri = host_array(packed.tri)
        try:
            tri_d = tri_dim(tri.size)
        except ValueError as e:
            raise PayloadError(str(e)) from None
        if tri_d != int(packed.dim):
            raise PayloadError(f"packed triangle has {tri.size} scalars "
                               f"(d={tri_d}), payload declares "
                               f"d={int(packed.dim)}")
        return cls(tri=tri, moment=host_array(packed.moment),
                   count=int(packed.count), dim=int(packed.dim),
                   client_id=client_id,
                   wire_dtype=_wire_name_or_f32(packed.tri.dtype),
                   yty=_packed_yty(packed) if moments else None)

    @classmethod
    def from_stats(cls, stats, client_id: str = "", *,
                   moments: bool = False) -> "StatsFrame":
        """From a ``SuffStats`` via the shared triangular pack codec."""
        from repro_torch.fed.protocol import PackedStats

        return cls.from_packed(PackedStats.pack(stats), client_id=client_id,
                               moments=moments)

    def to_packed(self, device="cuda", dtype=None):
        """Back into the in-process Thm-4 container (``fed.PackedStats``) on
        ``device``, in ``dtype`` (default: the decoded dtype)."""
        return _to_packed(self, device, dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class ProjectedFrame:
    """§IV-F sketched upload: m-dim stats plus the sketch's identity.

    Payload: u32 m, u32 d_orig, u64 seed, u64 rhash, u64 count,
    u16 id_len, client id utf-8, tri (m(m+1)/2 scalars), moment (m scalars)
    [, MOMENTS section: f64 yty — see :func:`_maybe_yty`].

    ``seed`` regenerates the shared R on the server (seed sharing is the
    paper's O(1) alternative to shipping R); ``rhash`` fingerprints the
    actual R bytes so two clients that *think* they share a sketch but do
    not (version skew, wrong seed) are rejected instead of silently fused.
    ``yty`` = Σ b² is featurization-invariant (targets never featurize), so
    sketched tenants serve the same inference algebra as dense ones.
    """

    tri: np.ndarray
    moment: np.ndarray
    count: int
    dim: int                 # m, the sketch dimension
    d_orig: int              # original feature dimension (for the lift)
    seed: int
    rhash: int
    client_id: str = ""
    wire_dtype: str = "f32"
    yty: float | None = None

    def to_packed(self, device="cuda", dtype=None):
        return _to_packed(self, device, dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class RFFFrame:
    """§IV-F RFF upload: D-dim feature-space stats plus the map's identity.

    Payload: u32 D, u32 d_orig, u64 seed, u64 fhash, f64 lengthscale,
    u64 count, u16 id_len, client id utf-8, tri (D(D+1)/2 scalars),
    moment (D scalars) [, MOMENTS section: f64 yty — see :func:`_maybe_yty`].

    The random-feature sibling of :class:`ProjectedFrame`: ``seed`` and
    ``lengthscale`` regenerate the shared (W, c) on the server, ``fhash``
    fingerprints the actual array bytes (``core.feature_hash``) so version
    skew between the two derivations is a typed rejection. Unlike the JL
    sketch, D may EXCEED d_orig — more random features only improve the
    kernel approximation — so decode does not enforce m <= d here.
    """

    tri: np.ndarray
    moment: np.ndarray
    count: int
    dim: int                 # D, the feature count
    d_orig: int              # original feature dimension
    seed: int
    fhash: int
    lengthscale: float = 1.0
    client_id: str = ""
    wire_dtype: str = "f32"
    yty: float | None = None

    def to_packed(self, device="cuda", dtype=None):
        return _to_packed(self, device, dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class DeltaRowsFrame:
    """§VI-C streaming delta: a raw row batch (the rows ARE update vectors).

    Payload: u32 n, u32 d, u16 id_len, client id utf-8, A (n*d row-major
    scalars), b (n scalars).
    """

    A: np.ndarray
    b: np.ndarray
    client_id: str = ""
    wire_dtype: str = "f32"


_CONTROL_OPS = {"drop": 1, "restore": 2}
_CONTROL_NAMES = {v: k for k, v in _CONTROL_OPS.items()}


@dataclasses.dataclass(frozen=True)
class ControlFrame:
    """Thm-8 control plane: drop or rejoin one client's contribution.

    Payload: u8 op (1=drop, 2=restore), u16 id_len, client id utf-8.
    """

    op: str
    client_id: str


@dataclasses.dataclass(frozen=True)
class SolveFrame:
    """Phase-3 query: the fused ridge solution at sigma. Payload: f64 sigma."""

    sigma: float


@dataclasses.dataclass(frozen=True, eq=False)
class WeightsFrame:
    """Server download: w_sigma (d scalars). Payload: u32 d, f64 sigma, w."""

    w: np.ndarray
    sigma: float
    wire_dtype: str = "f32"


@dataclasses.dataclass(frozen=True)
class AckFrame:
    """Status reply. Payload: u8 ok, u16 msg_len, message utf-8.

    Two append-only bits ride the header's flags byte (ACK frames only;
    every other frame type still requires flags == 0, so all pre-existing
    encodings are untouched):

      * bit 0 — ``retryable``: the rejection is transient (transit damage,
        an internal hiccup); the client may re-send the SAME frame and rely
        on server-side dedup. Cleared for semantic rejections (dimension
        mismatch, space mixing, quota, negotiation failure) — retrying those
        can never succeed.
      * bit 1 — ``duplicate``: this upload was already journaled and fused;
        the server deduplicated it (idempotent replay after a lost ACK) and
        nothing was applied twice. Always paired with ``ok=True``.

    A v1 peer that predates these bits decodes them as a reserved-flags
    rejection only for NON-ACK frames; old ACK bytes (flags=0) decode to
    ``retryable=False, duplicate=False`` and re-encode byte-identically.
    """

    ok: bool
    message: str = ""
    retryable: bool = False
    duplicate: bool = False


Frame = (Hello | StatsFrame | ProjectedFrame | RFFFrame | DeltaRowsFrame
         | ControlFrame | SolveFrame | WeightsFrame | AckFrame)

_FRAME_TYPES = {
    Hello: FT_HELLO, StatsFrame: FT_STATS, ProjectedFrame: FT_PROJ,
    DeltaRowsFrame: FT_DELTA, ControlFrame: FT_CONTROL, SolveFrame: FT_SOLVE,
    WeightsFrame: FT_WEIGHTS, AckFrame: FT_ACK, RFFFrame: FT_RFF,
}


# -- encode ------------------------------------------------------------------

def _offer_tag(name: str) -> int:
    """Offer name -> wire tag; round-trips the ``unknown:N`` names decode
    gives to tags this version does not speak (forward compatibility)."""
    if name in DTYPE_TAGS:
        return DTYPE_TAGS[name]
    if name.startswith("unknown:"):
        try:
            tag = int(name[len("unknown:"):])
        except ValueError:
            tag = 0
        if 0 < tag <= 0xFF and tag not in _TAG_NAMES:
            return tag
    raise PayloadError(f"un-encodable dtype offer {name!r}")


def _enc_str(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise PayloadError(f"string field too long ({len(b)} bytes)")
    return struct.pack("<H", len(b)) + b


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit patterns (u16), rounded to nearest even; a NaN
    becomes the quiet NaN of its sign. Wider input is first rounded to
    float32, as the JAX package's bf16 cast rounds it."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        r = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))))
    bits = (r >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(u.view(np.float32))
    if nan.any():
        bits[nan] = np.where(u[nan] >> np.uint32(31), 0xFFC0, 0x7FC0)
    return bits


def _enc_array(x, name: str, *, expect: int) -> bytes:
    arr = host_array(x)
    if arr.size != expect:
        raise PayloadError(f"array has {arr.size} scalars, layout needs {expect}")
    if name == "bf16":
        return _bf16_bits(arr).astype(_WIRE_NP["bf16"]).tobytes()
    return np.ascontiguousarray(arr, dtype=_WIRE_NP[name]).tobytes()


def _packed_yty(packed) -> float | None:
    """The residual second moment a ``PackedStats``-shaped payload carries."""
    yty = getattr(packed, "yty", None)
    return None if yty is None else float(yty)


def _to_packed(frame, device, dtype):
    """A STATS / PROJ / RFF frame's arrays as a port ``fed.PackedStats``."""
    from repro_torch.fed.protocol import PackedStats

    tri = torch.as_tensor(frame.tri).to(device=device, dtype=dtype)
    return PackedStats(
        tri=tri,
        moment=torch.as_tensor(frame.moment).to(device=device, dtype=dtype),
        count=torch.tensor(frame.count, dtype=torch.int32, device=device),
        dim=frame.dim,
        yty=None if frame.yty is None
        else torch.tensor(frame.yty, dtype=tri.dtype, device=device))


def _moments_section(yty: float) -> bytes:
    """Encode the optional trailing MOMENTS section: one f64 yty scalar.

    Always f64 regardless of the session's array dtype — one scalar costs
    nothing, and the widest encoding round-trips every container exactly.
    """
    v = float(yty)
    if not np.isfinite(v):
        raise PayloadError(f"yty must be finite, got {v}")
    return struct.pack("<d", v)


def encode_frame(frame: Frame, *, dtype: str | None = None) -> bytes:
    """Serialize one frame. ``dtype`` overrides the scalar encoding of array
    fields (the negotiated session dtype); scalars are cast exactly once here.
    """
    name = dtype or getattr(frame, "wire_dtype", None) or "f32"
    if name not in _WIRE_NP:
        raise BadDtype(f"unknown wire dtype {name!r}")

    if isinstance(frame, Hello):
        tags = bytes(_offer_tag(o) for o in frame.offers)
        if not tags:
            raise PayloadError("HELLO must offer at least one dtype")
        payload = struct.pack("<B", len(tags)) + tags + _enc_str(frame.tenant)
    elif isinstance(frame, StatsFrame):
        d = frame.dim
        _check_count(frame.count)
        payload = (struct.pack("<IQ", d, frame.count)
                   + _enc_str(frame.client_id)
                   + _enc_array(frame.tri, name, expect=tri_len(d))
                   + _enc_array(frame.moment, name, expect=d))
        if frame.yty is not None:
            payload += _moments_section(frame.yty)
    elif isinstance(frame, ProjectedFrame):
        m = frame.dim
        if not 0 < m <= frame.d_orig:
            raise PayloadError(f"need 0 < m <= d_orig, got m={m}, "
                               f"d_orig={frame.d_orig}")
        _check_count(frame.count)
        payload = (struct.pack("<IIQQQ", m, frame.d_orig, frame.seed,
                               frame.rhash, frame.count)
                   + _enc_str(frame.client_id)
                   + _enc_array(frame.tri, name, expect=tri_len(m))
                   + _enc_array(frame.moment, name, expect=m))
        if frame.yty is not None:
            payload += _moments_section(frame.yty)
    elif isinstance(frame, RFFFrame):
        D = frame.dim
        if D <= 0 or frame.d_orig <= 0:
            raise PayloadError(f"need D, d_orig > 0, got D={D}, "
                               f"d_orig={frame.d_orig}")
        ls = float(frame.lengthscale)
        if not (np.isfinite(ls) and ls > 0.0):
            raise PayloadError(
                f"lengthscale must be finite and > 0, got {ls}")
        _check_count(frame.count)
        payload = (struct.pack("<IIQQdQ", D, frame.d_orig, frame.seed,
                               frame.fhash, ls, frame.count)
                   + _enc_str(frame.client_id)
                   + _enc_array(frame.tri, name, expect=tri_len(D))
                   + _enc_array(frame.moment, name, expect=D))
        if frame.yty is not None:
            payload += _moments_section(frame.yty)
    elif isinstance(frame, DeltaRowsFrame):
        A = host_array(frame.A)
        if A.ndim != 2:
            raise PayloadError(f"delta rows must be 2-D, got shape {A.shape}")
        n, d = A.shape
        payload = (struct.pack("<II", n, d) + _enc_str(frame.client_id)
                   + _enc_array(A, name, expect=n * d)
                   + _enc_array(frame.b, name, expect=n))
    elif isinstance(frame, ControlFrame):
        if frame.op not in _CONTROL_OPS:
            raise PayloadError(f"unknown control op {frame.op!r}")
        payload = (struct.pack("<B", _CONTROL_OPS[frame.op])
                   + _enc_str(frame.client_id))
    elif isinstance(frame, SolveFrame):
        sigma = float(frame.sigma)
        if not (np.isfinite(sigma) and sigma > 0.0):
            raise PayloadError(f"sigma must be finite and > 0, got {sigma}")
        payload = struct.pack("<d", sigma)
    elif isinstance(frame, WeightsFrame):
        w = host_array(frame.w)
        payload = (struct.pack("<Id", w.size, float(frame.sigma))
                   + _enc_array(w, name, expect=w.size))
    elif isinstance(frame, AckFrame):
        payload = struct.pack("<B", 1 if frame.ok else 0) + _enc_str(frame.message)
    else:
        raise BadFrameType(f"cannot encode {type(frame).__name__}")

    flags = 0
    if isinstance(frame, AckFrame):
        flags = ((ACK_FLAG_RETRYABLE if frame.retryable else 0)
                 | (ACK_FLAG_DUPLICATE if frame.duplicate else 0))
    header = _HEADER.pack(MAGIC, VERSION, _FRAME_TYPES[type(frame)],
                          DTYPE_TAGS[name], flags, len(payload))
    body = header + payload
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


# -- decode ------------------------------------------------------------------

class _Cursor:
    """Bounds-checked sequential reader over one frame's payload."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.off + n > len(self.buf):
            raise PayloadError(
                f"payload overrun: need {n} bytes at offset {self.off}, "
                f"have {len(self.buf)}")
        out = self.buf[self.off:self.off + n]
        self.off += n
        return out

    def unpack(self, fmt: str):
        s = struct.Struct(fmt)
        return s.unpack(self.take(s.size))

    def string(self) -> str:
        (n,) = self.unpack("<H")
        try:
            return self.take(n).decode("utf-8")
        except UnicodeDecodeError as e:
            raise PayloadError(f"invalid utf-8 in string field: {e}") from None

    def array(self, name: str, count: int) -> np.ndarray:
        wdt = _WIRE_NP[name]
        raw = np.frombuffer(self.take(count * wdt.itemsize), dtype=wdt)
        # Deterministic upcast to the decode dtype; always a fresh, writable,
        # native-endian array (frombuffer views are read-only).
        if name == "bf16":
            return (raw.astype(np.uint32) << np.uint32(16)).view(np.float32)
        return raw.astype(_WIRE_NP[DECODES_TO[name]])

    def done(self) -> None:
        if self.off != len(self.buf):
            raise PayloadError(
                f"{len(self.buf) - self.off} trailing payload bytes")


def _maybe_yty(cur: _Cursor) -> float | None:
    """Optional trailing MOMENTS section of an upload payload: one f64 yty.

    Presence is inferred from the payload length — zero bytes remaining
    after the layout's arrays is a legacy (moments-less) payload, exactly 8
    is the section; any other remainder falls through to ``done()``'s
    trailing-bytes rejection. A length cue instead of a flags bit keeps
    chunking's flags==0 invariant intact and every pre-moments encoding
    byte-identical; a pre-moments decoder rejects moments-bearing frames
    with the same typed trailing-bytes error, never a silent mis-decode.
    """
    if len(cur.buf) - cur.off != 8:
        return None
    (yty,) = cur.unpack("<d")
    if not np.isfinite(yty):
        raise PayloadError(f"yty must be finite, got {yty}")
    return yty


def _check_dim(d: int, what: str = "d") -> int:
    if not 0 < d <= MAX_DIM:
        raise PayloadError(f"{what}={d} out of range (1..{MAX_DIM})")
    return d


def _check_count(count: int) -> int:
    if count > MAX_COUNT:
        raise PayloadError(f"count={count} exceeds the int32 container "
                           f"bound {MAX_COUNT}")
    return count


def frame_total_length(header: bytes, *,
                       max_payload_bytes: int = MAX_PAYLOAD_BYTES) -> int:
    """Total frame length from its 12-byte header (the transport read loop).

    Validates just enough to trust the length field: magic, version, and the
    payload-length cap. Full validation happens in :func:`decode_frame`.
    ``max_payload_bytes`` relaxes the cap for reassembled/journaled frames
    (:data:`MAX_REASSEMBLED_BYTES`); the wire itself keeps the strict one.
    """
    if len(header) < HEADER_BYTES:
        raise TruncatedFrame(
            f"header needs {HEADER_BYTES} bytes, got {len(header)}")
    magic, version, _, _, _, plen = _HEADER.unpack(header[:HEADER_BYTES])
    if magic != MAGIC:
        raise BadMagic(f"bad magic {magic!r}")
    if version != VERSION:
        raise BadVersion(f"unsupported version {version} (speak {VERSION})")
    if plen > max_payload_bytes:
        raise BadLength(f"payload length {plen} exceeds cap {max_payload_bytes}")
    return HEADER_BYTES + plen + TRAILER_BYTES


def _envelope(buf: bytes, *, max_payload_bytes: int) -> tuple[int, int, int]:
    """Shared envelope validation: exact length + CRC. Returns
    ``(ftype, dtag, flags)``; the payload is ``buf[12:-4]``."""
    total = frame_total_length(buf, max_payload_bytes=max_payload_bytes)
    if len(buf) < total:
        raise TruncatedFrame(f"frame declares {total} bytes, got {len(buf)}")
    if len(buf) > total:
        raise BadLength(f"{len(buf) - total} trailing bytes after frame")
    _, _, ftype, dtag, flags, _ = _HEADER.unpack(buf[:HEADER_BYTES])
    (crc,) = struct.unpack("<I", buf[total - TRAILER_BYTES:total])
    actual = zlib.crc32(buf[:total - TRAILER_BYTES]) & 0xFFFFFFFF
    if crc != actual:
        raise ChecksumMismatch(f"crc {crc:#010x} != computed {actual:#010x}")
    return ftype, dtag, flags


def decode_frame(buf: bytes, *,
                 max_payload_bytes: int = MAX_PAYLOAD_BYTES) -> Frame:
    """Parse and strictly validate exactly one frame.

    Rejections are always a :class:`WireError` subclass; arbitrary input
    bytes can never crash the decoder or yield a frame that does not
    re-encode to the same bytes. A valid continuation chunk raises
    :class:`ContinuationChunk` — its payload is a partial byte slice, not a
    decodable frame; callers with a reassembly path catch that one type.
    """
    ftype, dtag, flags = _envelope(buf, max_payload_bytes=max_payload_bytes)
    _, _, _, _, _, plen = _HEADER.unpack(buf[:HEADER_BYTES])
    if ftype == FT_ACK:
        if flags & ~_ACK_FLAGS_MASK:
            raise PayloadError(
                f"unknown ACK flags bits {flags:#04x} "
                f"(defined mask {_ACK_FLAGS_MASK:#04x})")
    elif flags & FLAG_CONTINUED and ftype in CHUNKABLE_FRAME_TYPES:
        if flags & ~FLAG_CONTINUED:
            raise PayloadError(
                f"unknown upload flags bits {flags:#04x} "
                f"(defined mask {FLAG_CONTINUED:#04x})")
        raise ContinuationChunk(
            f"frame type {ftype:#04x} chunk of {plen} payload bytes: "
            f"reassemble before decoding")
    elif flags != 0:
        raise PayloadError(f"reserved flags byte must be 0, got {flags}")
    if dtag not in _TAG_NAMES:
        raise BadDtype(f"unknown dtype tag {dtag}")
    name = _TAG_NAMES[dtag]
    cur = _Cursor(buf[HEADER_BYTES:HEADER_BYTES + plen])

    if ftype == FT_HELLO:
        (n_offers,) = cur.unpack("<B")
        if n_offers < 1:
            raise PayloadError("HELLO must offer at least one dtype")
        tags = cur.take(n_offers)
        if len(set(tags)) != n_offers:
            raise PayloadError(f"duplicate dtype offers {list(tags)}")
        # Unknown tags are preserved (as "unknown:N"), not rejected: a newer
        # client offering a future encoding alongside f32 must still be able
        # to negotiate down — negotiate() skips names it cannot use, and
        # re-encoding restores the original tag bytes.
        offers = tuple(_TAG_NAMES.get(t, f"unknown:{t}") for t in tags)
        frame: Frame = Hello(tenant=cur.string(), offers=offers)
    elif ftype == FT_STATS:
        d, count = cur.unpack("<IQ")
        _check_dim(d)
        _check_count(count)
        cid = cur.string()
        frame = StatsFrame(tri=cur.array(name, tri_len(d)),
                           moment=cur.array(name, d), count=count, dim=d,
                           client_id=cid, wire_dtype=name,
                           yty=_maybe_yty(cur))
    elif ftype == FT_PROJ:
        m, d_orig, seed, rhash, count = cur.unpack("<IIQQQ")
        _check_dim(m, "m")
        _check_dim(d_orig, "d_orig")
        _check_count(count)
        if m > d_orig:
            raise PayloadError(f"sketch m={m} > original d={d_orig}")
        cid = cur.string()
        frame = ProjectedFrame(tri=cur.array(name, tri_len(m)),
                               moment=cur.array(name, m), count=count, dim=m,
                               d_orig=d_orig, seed=seed, rhash=rhash,
                               client_id=cid, wire_dtype=name,
                               yty=_maybe_yty(cur))
    elif ftype == FT_RFF:
        D, d_orig, seed, fhash, lengthscale, count = cur.unpack("<IIQQdQ")
        _check_dim(D, "D")
        _check_dim(d_orig, "d_orig")
        _check_count(count)
        # No D <= d_orig check: extra random features only sharpen the
        # kernel approximation, D > d is a legitimate regime.
        if not (np.isfinite(lengthscale) and lengthscale > 0.0):
            raise PayloadError(
                f"lengthscale must be finite and > 0, got {lengthscale}")
        cid = cur.string()
        frame = RFFFrame(tri=cur.array(name, tri_len(D)),
                         moment=cur.array(name, D), count=count, dim=D,
                         d_orig=d_orig, seed=seed, fhash=fhash,
                         lengthscale=lengthscale, client_id=cid,
                         wire_dtype=name, yty=_maybe_yty(cur))
    elif ftype == FT_DELTA:
        n, d = cur.unpack("<II")
        if not 0 < n <= MAX_ROWS:
            raise PayloadError(f"row count {n} out of range (1..{MAX_ROWS})")
        _check_dim(d)
        cid = cur.string()
        frame = DeltaRowsFrame(A=cur.array(name, n * d).reshape(n, d),
                               b=cur.array(name, n), client_id=cid,
                               wire_dtype=name)
    elif ftype == FT_CONTROL:
        (op,) = cur.unpack("<B")
        if op not in _CONTROL_NAMES:
            raise PayloadError(f"unknown control op {op}")
        frame = ControlFrame(op=_CONTROL_NAMES[op], client_id=cur.string())
    elif ftype == FT_SOLVE:
        (sigma,) = cur.unpack("<d")
        if not (np.isfinite(sigma) and sigma > 0.0):
            raise PayloadError(f"sigma must be finite and > 0, got {sigma}")
        frame = SolveFrame(sigma=sigma)
    elif ftype == FT_WEIGHTS:
        d, sigma = cur.unpack("<Id")
        _check_dim(d)
        frame = WeightsFrame(w=cur.array(name, d), sigma=sigma,
                             wire_dtype=name)
    elif ftype == FT_ACK:
        (ok,) = cur.unpack("<B")
        if ok > 1:
            raise PayloadError(f"ack status must be 0/1, got {ok}")
        frame = AckFrame(ok=bool(ok), message=cur.string(),
                         retryable=bool(flags & ACK_FLAG_RETRYABLE),
                         duplicate=bool(flags & ACK_FLAG_DUPLICATE))
    else:
        raise BadFrameType(f"unknown frame type {ftype:#04x}")
    cur.done()
    return frame


# -- analytic sizes (the ledger's measured-bytes column) ---------------------

MOMENTS_SECTION_BYTES = 8    # the optional trailing f64 yty scalar


def stats_frame_nbytes(d: int, dtype: str = "f32", *, client_id: str = "",
                       moments: bool = False) -> int:
    """Exact encoded length of a Thm-4 STATS frame (header + payload + crc)."""
    meta = 4 + 8 + 2 + len(client_id.encode("utf-8"))
    return (OVERHEAD_BYTES + meta + (tri_len(d) + d) * wire_itemsize(dtype)
            + (MOMENTS_SECTION_BYTES if moments else 0))


def projected_frame_nbytes(m: int, dtype: str = "f32", *,
                           client_id: str = "", moments: bool = False) -> int:
    """Exact encoded length of a §IV-F PROJ frame."""
    meta = 4 + 4 + 8 + 8 + 8 + 2 + len(client_id.encode("utf-8"))
    return (OVERHEAD_BYTES + meta + (tri_len(m) + m) * wire_itemsize(dtype)
            + (MOMENTS_SECTION_BYTES if moments else 0))


def delta_frame_nbytes(n: int, d: int, dtype: str = "f32", *,
                       client_id: str = "") -> int:
    """Exact encoded length of a §VI-C DELTA frame."""
    meta = 4 + 4 + 2 + len(client_id.encode("utf-8"))
    return OVERHEAD_BYTES + meta + (n * d + n) * wire_itemsize(dtype)


def rff_frame_nbytes(D: int, dtype: str = "f32", *, client_id: str = "",
                     moments: bool = False) -> int:
    """Exact encoded length of a §IV-F RFF frame."""
    meta = 4 + 4 + 8 + 8 + 8 + 8 + 2 + len(client_id.encode("utf-8"))
    return (OVERHEAD_BYTES + meta + (tri_len(D) + D) * wire_itemsize(dtype)
            + (MOMENTS_SECTION_BYTES if moments else 0))


def encoded_nbytes(payload, *, frame: str = "tri",
                   client_id: str = "") -> int:
    """Encoded frame length a ``PackedStats``-shaped upload costs on the wire.

    ``frame`` is "tri" (Thm-4 STATS), "proj" (§IV-F sketch), or "rff".
    Raises :class:`BadDtype` when the payload's dtype has no wire encoding.
    """
    name = dtype_name(payload.tri.dtype)
    if frame == "tri":
        return stats_frame_nbytes(payload.dim, name, client_id=client_id)
    if frame == "proj":
        return projected_frame_nbytes(payload.dim, name, client_id=client_id)
    if frame == "rff":
        return rff_frame_nbytes(payload.dim, name, client_id=client_id)
    raise ValueError(f"frame must be 'tri', 'proj', or 'rff', got {frame!r}")


def frame_crc(data: bytes) -> int:
    """A frame's own CRC32 trailer (the last 4 bytes of its encoding).

    This is the payload fingerprint the server's idempotent-replay index
    keys on: two byte-identical uploads share it by construction, and a
    frame that differs in any byte (different stats, different count,
    different client id) differs in it with CRC32 confidence. No re-hash:
    the trailer was already computed at encode time.
    """
    if len(data) < OVERHEAD_BYTES:
        raise TruncatedFrame(f"frame needs >= {OVERHEAD_BYTES} bytes, "
                             f"got {len(data)}")
    (crc,) = struct.unpack("<I", data[-TRAILER_BYTES:])
    return crc


# -- streaming multi-frame uploads (continuation chunks) ---------------------

def chunk_parts(buf: bytes) -> tuple[int, int, int, bytes]:
    """Validate one received frame's ENVELOPE only (magic/version/length/CRC)
    and return ``(ftype, dtype_tag, flags, payload)`` without parsing the
    payload — the reassembly path's view of a chunk. Raises the same typed
    errors as :func:`decode_frame` for transit damage.
    """
    ftype, dtag, flags = _envelope(buf, max_payload_bytes=MAX_PAYLOAD_BYTES)
    return ftype, dtag, flags, buf[HEADER_BYTES:len(buf) - TRAILER_BYTES]


def split_frame(raw: bytes, *, max_chunk_payload: int) -> list[bytes]:
    """Split one encoded frame into continuation chunks of at most
    ``max_chunk_payload`` payload bytes each.

    Returns ``[raw]`` unchanged when the payload already fits (the common
    case stays byte-identical). Otherwise every chunk is a complete, CRC'd
    wire frame of the SAME type: all but the last carry
    :data:`FLAG_CONTINUED`; the last carries flags 0 and terminates the
    sequence. ``join_chunks`` of the result reproduces ``raw`` exactly.
    """
    if max_chunk_payload < 1:
        raise BadLength(f"max_chunk_payload must be >= 1, "
                        f"got {max_chunk_payload}")
    ftype, dtag, flags = _envelope(buf=raw,
                                   max_payload_bytes=MAX_REASSEMBLED_BYTES)
    if flags != 0:
        raise PayloadError("cannot chunk a frame that already carries flags")
    payload = raw[HEADER_BYTES:len(raw) - TRAILER_BYTES]
    if len(payload) <= max_chunk_payload:
        return [raw]
    if ftype not in CHUNKABLE_FRAME_TYPES:
        raise BadFrameType(
            f"frame type {ftype:#04x} does not support continuation chunks")
    out = []
    for off in range(0, len(payload), max_chunk_payload):
        part = payload[off:off + max_chunk_payload]
        last = off + max_chunk_payload >= len(payload)
        header = _HEADER.pack(MAGIC, VERSION, ftype, dtag,
                              0 if last else FLAG_CONTINUED, len(part))
        body = header + part
        out.append(body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF))
    return out


def join_chunks(ftype: int, dtag: int, parts) -> bytes:
    """Reassemble chunk payload slices into the canonical unchunked frame.

    The result is byte-identical to :func:`encode_frame` of the logical
    frame (flags 0, one CRC over the whole payload) — so the dedup key
    ``(client_id, frame_crc)`` and the journal record are invariant to how
    the frame was transported.
    """
    payload = b"".join(parts)
    if len(payload) > MAX_REASSEMBLED_BYTES:
        raise BadLength(f"reassembled payload {len(payload)} exceeds the u32 "
                        f"length field ({MAX_REASSEMBLED_BYTES})")
    header = _HEADER.pack(MAGIC, VERSION, ftype, dtag, 0, len(payload))
    body = header + payload
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


# -- relay identity (hierarchical aggregation, server.relay) -----------------

RELAY_CLIENT_PREFIX = "relay:"


def relay_client_id(relay_id: str, epoch: int) -> str:
    """The client id a relay stamps on its forwarded fused frame.

    One id per (relay, forward epoch): re-sends of the SAME epoch (retries
    after a lost ACK, restarts replaying a persisted pending frame) are
    byte-identical and dedup upstream, while the next epoch's delta is a new
    id and fuses. The prefix marks the frame's tier for the pool ledger.
    """
    if not relay_id or "#" in relay_id:
        raise PayloadError(f"bad relay id {relay_id!r} (nonempty, no '#')")
    return f"{RELAY_CLIENT_PREFIX}{relay_id}#{int(epoch):08d}"


def is_relay_client(client_id) -> bool:
    """Whether an upload's client id marks a relay-forwarded frame."""
    return (isinstance(client_id, str)
            and client_id.startswith(RELAY_CLIENT_PREFIX))


def projection_hash(R) -> int:
    """Fingerprint of a §IV-F sketch: CRC32 of R's canonical f32 bytes.

    Client and server each hash the R they derived from the shared seed; a
    mismatch in a PROJ frame means the two sides do not actually share a
    sketch (version skew, wrong seed) and the upload must be rejected —
    fusing stats from different sketches is silent garbage.
    """
    arr = np.ascontiguousarray(host_array(R), dtype="<f4")
    return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
