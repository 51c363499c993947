"""Communication accounting (paper Theorem 4 / Corollary 2).

Counts are in *floats per client*; the analytic ``bytes`` columns assume
fp32 (4 bytes) as the paper's MB figures do. Upload for One-Shot exploits
Gram symmetry: d(d+1)/2 + d floats up, d down. FedAvg: R*d up and R*d down.

A copy of the reference's ``fed/comm.py`` (it has no JAX in it, but the port
imports nothing of the reference), with the wire codec's frame-length closed
forms copied in below.

Since the protocol runs actually ship :class:`~repro_torch.fed.protocol.PackedStats`
payloads (the Gram's d(d+1)/2 lower triangle, not the full square),
``measured_one_shot`` builds the record from the *payload arrays themselves* —
and its byte column is the **encoded frame length** (the wire codec: 16-byte
header+CRC envelope, frame metadata, scalars at the negotiated dtype's
width), not float-count x 4. The Thm-4 analytic column stays alongside
(``analytic_total_bytes``) for the paper tables, and a test pins
measured-floats == Thm 4's formula and measured-bytes == the exact encoded
frame size, so neither can drift silently.

The sharded serving path (server.distributed.ShardedBackend) adds a second
ledger axis: beyond the client->server uploads Theorem 4 counts, the on-mesh
psum of the fused statistics moves bytes *between shards*.
``sharded_oneshot_record`` accounts both — per-client uploads exactly as
``one_shot_comm`` (including the §IV-F projected O(m^2) variant, so
Table-IV-style comparisons cover the sharded path too) plus per-mesh-axis
ring all-reduce traffic for the one fusion psum.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

FLOAT_BYTES = 4


@dataclasses.dataclass(frozen=True)
class CommRecord:
    """Byte ledger for one protocol execution (per-client and total).

    The float columns are the paper's Thm-4 accounting. When the record was
    measured from actual wire payloads, ``upload_wire_bytes_per_client`` /
    ``download_wire_bytes_per_client`` hold the *encoded frame lengths*
    (header + metadata + scalars at the negotiated dtype) and the byte
    properties report those; otherwise the bytes fall back to the analytic
    floats x 4 column. ``analytic_*`` always gives the formula column, so
    tables can show both side by side.
    """

    upload_floats_per_client: int
    download_floats_per_client: int
    num_clients: int
    rounds: int
    upload_wire_bytes_per_client: int | None = None
    download_wire_bytes_per_client: int | None = None

    @property
    def analytic_per_client_bytes(self) -> int:
        """The Thm-4 column: floats x 4, no framing, no dtype negotiation."""
        return (self.upload_floats_per_client
                + self.download_floats_per_client) * FLOAT_BYTES

    @property
    def analytic_total_bytes(self) -> int:
        return self.analytic_per_client_bytes * self.num_clients

    @property
    def analytic_total_mb(self) -> float:
        """The paper-table MB column (Thm-4 formula; comparable with the
        FedAvg rows, which are always analytic)."""
        return self.analytic_total_bytes / 2**20

    @property
    def per_client_bytes(self) -> int:
        up, down = (self.upload_wire_bytes_per_client,
                    self.download_wire_bytes_per_client)
        if up is None and down is None:
            return self.analytic_per_client_bytes
        return ((up if up is not None
                 else self.upload_floats_per_client * FLOAT_BYTES)
                + (down if down is not None
                   else self.download_floats_per_client * FLOAT_BYTES))

    @property
    def total_bytes(self) -> int:
        return self.per_client_bytes * self.num_clients

    @property
    def total_mb(self) -> float:
        return self.total_bytes / 2**20


def one_shot_comm(d: int, num_clients: int, *, projected_m: int | None = None) -> CommRecord:
    """Thm 4 row 1 (+ §IV-F when projected): up d(d+1)/2 + d, down d."""
    k = d if projected_m is None else projected_m
    return CommRecord(
        upload_floats_per_client=k * (k + 1) // 2 + k,
        download_floats_per_client=k,
        num_clients=num_clients,
        rounds=1,
    )


# -- encoded frame lengths ----------------------------------------------------
# Private copy of the wire codec's closed forms for the three upload frames
# (``repro.fed.wire``: header + CRC envelope, frame metadata, scalars at the
# payload dtype's width). They move into the port's own ``fed/wire.py`` when
# the codec is ported.

_OVERHEAD_BYTES = 12 + 4                 # header + CRC32 trailer
_WIRE_ITEMSIZE = {"f32": 4, "f64": 8, "bf16": 2}
_WIRE_NAMES = {"float32": "f32", "float64": "f64", "bfloat16": "bf16"}


class _NoWireDtype(ValueError):
    """The payload dtype has no wire encoding."""


def _wire_name(dtype) -> str:
    name = str(dtype).removeprefix("torch.")
    if name not in _WIRE_NAMES:
        raise _NoWireDtype(f"dtype {dtype} has no wire encoding "
                           f"(supported: {sorted(_WIRE_ITEMSIZE)})")
    return _WIRE_NAMES[name]


def _tri_len(d: int) -> int:
    return d * (d + 1) // 2


def _stats_frame_nbytes(d: int, dtype: str) -> int:
    """Encoded length of a Thm-4 STATS frame with an empty client id."""
    return _OVERHEAD_BYTES + (4 + 8 + 2) + (_tri_len(d) + d) * _WIRE_ITEMSIZE[dtype]


def _projected_frame_nbytes(m: int, dtype: str) -> int:
    """Encoded length of a §IV-F PROJ frame with an empty client id."""
    return (_OVERHEAD_BYTES + (4 + 4 + 8 + 8 + 8 + 2)
            + (_tri_len(m) + m) * _WIRE_ITEMSIZE[dtype])


def _rff_frame_nbytes(D: int, dtype: str) -> int:
    """Encoded length of a §IV-F RFF frame with an empty client id."""
    return (_OVERHEAD_BYTES + (4 + 4 + 8 + 8 + 8 + 8 + 2)
            + (_tri_len(D) + D) * _WIRE_ITEMSIZE[dtype])


_FRAME_NBYTES = {"tri": _stats_frame_nbytes, "proj": _projected_frame_nbytes,
                 "rff": _rff_frame_nbytes}


def _encoded_nbytes(payload, *, frame: str = "tri") -> int:
    """Encoded frame length a ``PackedStats``-shaped upload costs."""
    if frame not in _FRAME_NBYTES:
        raise ValueError(f"frame must be 'tri', 'proj', or 'rff', got {frame!r}")
    return _FRAME_NBYTES[frame](payload.dim, _wire_name(payload.tri.dtype))


def measured_one_shot(payloads, download_floats: int, *,
                      frame: str = "tri") -> CommRecord:
    """Ledger from actual wire payloads, not the Thm 4 formula.

    ``payloads`` is the per-client upload collection (anything with a
    ``wire_floats`` property and ``tri``/``dim`` arrays, e.g.
    ``fed.protocol.PackedStats``); the upload count must be *common* across
    clients (Thm 4 is a per-client bound and every client ships the same
    shapes — a heterogeneous collection is a bug made loud here, not
    averaged away).

    The byte column is the exact **encoded frame length** each upload costs
    on the wire (the wire codec; ``frame`` picks the Thm-4 "tri" or §IV-F
    "proj" layout, per the payload's own dtype). Payloads whose dtype has no
    wire encoding fall back to the analytic floats x 4 column.
    """
    payloads = list(payloads)
    sizes = {int(p.wire_floats) for p in payloads}
    if len(sizes) > 1:
        raise ValueError(f"heterogeneous upload payloads: {sorted(sizes)}")
    upload_wire_bytes = None
    if payloads:
        try:
            encoded = {_encoded_nbytes(p, frame=frame) for p in payloads}
        except _NoWireDtype:
            encoded = set()    # no wire encoding for this dtype: analytic only
        if len(encoded) > 1:
            raise ValueError(
                f"heterogeneous encoded frame sizes: {sorted(encoded)}")
        if encoded:
            upload_wire_bytes = encoded.pop()
    return CommRecord(
        upload_floats_per_client=max(sizes) if sizes else 0,
        download_floats_per_client=download_floats,
        num_clients=len(payloads),
        rounds=1,
        upload_wire_bytes_per_client=upload_wire_bytes,
    )


@dataclasses.dataclass(frozen=True)
class ShardedCommRecord(CommRecord):
    """CommRecord plus cross-shard reduction traffic for on-mesh fusion.

    ``psum_floats_per_axis`` counts floats moved per device by the single
    fusion reduction along each mesh axis the reduction actually crosses
    (the row/client axes — the model axis only slices locally). The Gram is
    *reduce-scattered* into the block layout (a ring reduce-scatter of a
    p-float payload over an axis of size n moves (n-1)/n * p floats per
    device; the fused G is never all-gathered), while the d-float moment and
    the count are all-reduced (2 (n-1)/n * p). Payloads are the full square
    d^2 (+ d + 1) on-mesh statistic — symmetry is a wire optimization for
    uploads, not for device-to-device collectives.
    """

    psum_floats_per_axis: tuple[tuple[str, int], ...] = ()

    @property
    def psum_bytes_per_axis(self) -> dict[str, int]:
        return {ax: f * FLOAT_BYTES for ax, f in self.psum_floats_per_axis}

    @property
    def cross_shard_bytes(self) -> int:
        """Total per-device cross-shard bytes for the one fusion round."""
        return sum(self.psum_bytes_per_axis.values())


def sharded_oneshot_record(d: int, num_clients: int,
                           axis_sizes: Mapping[str, int], *,
                           projected_m: int | None = None) -> ShardedCommRecord:
    """Thm 4 uploads + on-mesh psum traffic for the sharded fusion path.

    Args:
      d: feature dimension (uploads use ``projected_m`` when given — the
        §IV-F O(m^2) record, so projected and unprojected sharded runs are
        comparable in one table).
      num_clients: uploading clients (process-level or mesh shards).
      axis_sizes: mesh axes the fusion reduction crosses -> axis size
        (``ShardedBackend.fusion_axis_sizes``: the row/client axes only,
        e.g. ``{"data": 16}`` or ``{"pod": 2, "data": 16}``).
      projected_m: optional §IV-F projection dimension.
    """
    base = one_shot_comm(d, num_clients, projected_m=projected_m)
    k = d if projected_m is None else projected_m
    per_axis = tuple(
        (ax, ((n - 1) * k * k + 2 * (n - 1) * (k + 1)) // max(n, 1))
        for ax, n in axis_sizes.items() if n > 1)
    return ShardedCommRecord(
        upload_floats_per_client=base.upload_floats_per_client,
        download_floats_per_client=base.download_floats_per_client,
        num_clients=base.num_clients,
        rounds=base.rounds,
        psum_floats_per_axis=per_axis,
    )


def aggregate_records(records: Mapping[str, CommRecord], *,
                      kinds: Mapping[str, str] | None = None) -> dict:
    """Roll a set of per-tenant CommRecords up into one pool-level ledger.

    Tenants are independent fusion problems, so bytes simply add; the rollup
    also keeps the per-tenant breakdown so a pool operator can see which
    tenant's uploads dominate. Cross-shard psum traffic (ShardedCommRecord)
    is reported separately from client-upload bytes — they move on different
    networks (DCN uploads vs ICI collectives) and adding them would hide
    exactly the distinction Thm 4 is about.

    ``kinds`` maps tenant name -> tenant kind ("dense" / "sketched" /
    "rff"); when given, the rollup adds a ``by_kind`` split so the §IV-F
    O(d²) -> O(m²) upload reduction is directly readable: a pool mixing
    dense and sketched tenants shows the dense kind carrying almost all the
    bytes. Names absent from ``kinds`` count as "dense".
    """
    per_tenant = {}
    upload_bytes = cross_shard = 0
    by_kind: dict[str, dict] = {}
    for name, rec in records.items():
        entry = {"upload_download_bytes": rec.total_bytes,
                 "analytic_bytes": rec.analytic_total_bytes,
                 "num_clients": rec.num_clients, "rounds": rec.rounds}
        upload_bytes += rec.total_bytes
        if isinstance(rec, ShardedCommRecord):
            entry["cross_shard_bytes"] = rec.cross_shard_bytes
            cross_shard += rec.cross_shard_bytes
        if kinds is not None:
            kind = kinds.get(name, "dense")
            entry["kind"] = kind
            k = by_kind.setdefault(kind, {"tenants": 0,
                                          "upload_download_bytes": 0,
                                          "analytic_bytes": 0})
            k["tenants"] += 1
            k["upload_download_bytes"] += rec.total_bytes
            k["analytic_bytes"] += rec.analytic_total_bytes
        per_tenant[name] = entry
    out = {
        "tenants": len(per_tenant),
        "upload_download_bytes": upload_bytes,
        "cross_shard_bytes": cross_shard,
        "total_mb": upload_bytes / 2**20,
        "per_tenant": per_tenant,
    }
    if kinds is not None:
        out["by_kind"] = by_kind
    return out


def hierarchical_ingress(d: int, num_clients: int, num_relays: int, *,
                         forwards_per_relay: int = 1) -> dict:
    """Root-ingress accounting for a two-tier topology (``server.relay``).

    Thm-1 additivity makes fusion associative, so interposing a relay tier
    changes no bits of the recovered solution — only *where* the frames
    land. Flat: every one of ``num_clients`` Thm-4 frames hits the root.
    Two-tier: each relay absorbs its region's uploads and ships
    ``forwards_per_relay`` fused frames (1 on a clean shutdown-flush; more
    under a periodic forwarding policy), so root ingress is O(relays).
    Frames are the same d-space size at both tiers — the reduction is in
    *count*, which is exactly what a connection-bound root buys.
    """
    per_frame_floats = d * (d + 1) // 2 + d
    flat_frames = num_clients
    relay_frames = num_relays * forwards_per_relay
    return {
        "dim": d,
        "flat_root_frames": flat_frames,
        "relayed_root_frames": relay_frames,
        "ingress_reduction": flat_frames / max(relay_frames, 1),
        "flat_root_bytes": flat_frames * per_frame_floats * FLOAT_BYTES,
        "relayed_root_bytes": relay_frames * per_frame_floats * FLOAT_BYTES,
    }


def fedavg_comm(d: int, num_clients: int, rounds: int) -> CommRecord:
    """Thm 4 row 2: R*d up, R*d down per client."""
    return CommRecord(
        upload_floats_per_client=rounds * d,
        download_floats_per_client=rounds * d,
        num_clients=num_clients,
        rounds=rounds,
    )


def crossover_rounds(d: int) -> float:
    """Corollary 2: One-Shot wins total communication iff R > (d + 5) / 4."""
    return (d + 5) / 4
