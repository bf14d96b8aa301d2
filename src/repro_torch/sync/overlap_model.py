"""The analytic step-time model behind ``sync_delay="auto"``.

Copies of ``benchmarks/hardware.py`` (``Chip``, ``CHIPS``) and of
``benchmarks/overlap.py`` (``_allreduce_t`` ... ``period_times``, and
``resolve_sync_delay``): the roofline inner step plus the ring all-reduce
of the (possibly compressed, hierarchical) Δθ payload, from which
``sync/delay.py:ModelDelayController`` reads d* = ceil(t_comm / t_inner).
The port imports nothing of the reference or its benchmarks, so it keeps
this copy; ``tests/test_torch_controllers.py`` holds it equal to the
original. The chip table is the reference's: a chip it does not name (an
H100 among them) warns and resolves to eager, d* = 0.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Optional

@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float  # /s (bf16)
    hbm_bw: float  # B/s
    intra_group_bw: float  # B/s per device, fast domain
    inter_group_bw: float  # B/s per device, slow/global domain
    hbm_bytes: float


TPU_V5E = Chip(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    intra_group_bw=50e9,  # ICI per link
    inter_group_bw=25e9,  # pod-crossing / DCN effective per device
    hbm_bytes=16 * 2**30,
)

A100_PERLMUTTER = Chip(
    name="a100-perlmutter",
    peak_flops=312e12,  # bf16 dense
    hbm_bw=1555e9,
    intra_group_bw=300e9,  # NVLink3 effective per GPU
    inter_group_bw=12.5e9,  # Slingshot-11 per-GPU share (4x25GB/s / 4 GPUs / 2 dir)
    hbm_bytes=40 * 2**30,
)

GH200_VISTA = Chip(
    name="gh200-vista",
    peak_flops=989e12,
    hbm_bw=4000e9,
    intra_group_bw=450e9,  # NVLink-C2C
    inter_group_bw=25e9,  # IB NDR 400 Gbps / 2 dir
    hbm_bytes=96 * 2**30,
)

CHIPS = {c.name: c for c in (TPU_V5E, A100_PERLMUTTER, GH200_VISTA)}

TOKENS_PER_STEP = 512 * 1024  # paper: global batch 512, seq 1024


def _allreduce_t(bytes_: float, n: int, bw: float) -> float:
    if n <= 1:
        return 0.0
    return 2 * bytes_ * (n - 1) / n / bw


def inner_step_time(n_params: float, n_devices: int, chip: Chip,
                    group_size: int) -> float:
    """Modeled seconds per inner step (compute + in-group grad sync)."""
    flops = 6 * n_params * TOKENS_PER_STEP / n_devices
    t_compute = flops / chip.peak_flops
    t_hbm = (20 * n_params / n_devices) / chip.hbm_bw
    grad_bytes = n_params * 4.0
    t_inner_comm = _allreduce_t(grad_bytes, min(group_size, n_devices),
                                chip.intra_group_bw)
    return max(t_compute, t_hbm) + t_inner_comm


def payload_bytes_per_param(bits: int = 32, block: int = 256) -> float:
    """Bytes per Δθ element on the slow domain: values + per-block scales.

    bits >= 32 means the uncompressed fp32 payload. int4 is 2x nibble
    packing of the int8-held values — since DESIGN.md §8 the Int8Wire
    strategy really packs the wire that way (pack_wire), and the
    measured_* fields report the actual buffer sizes next to this model.
    """
    if bits >= 32:
        return 4.0
    return bits / 8.0 + 4.0 / block


def cross_domain_bytes(n_params: float, *, n_groups: int, pods: int = 1,
                       bits: int = 32, block: int = 256,
                       hierarchical: bool = False) -> float:
    """Total bytes crossing the slow domain per sync.

    A ring all-reduce of a P-byte payload over E endpoints moves
    ``2·P·(E−1)`` bytes through the domain. Flat: E = n_groups at full
    payload width. Hierarchical: the fp32 reduce happens intra-pod (fast
    domain, not counted here) and only E = pods endpoints exchange the
    compressed payload.
    """
    per = n_params * payload_bytes_per_param(bits, block)
    e = max(pods if hierarchical else n_groups, 1)
    return 2.0 * per * (e - 1)


def rs_ag_bytes_per_device(n_params: float, *, endpoints: int,
                           bits: int = 8,
                           block: int = 256) -> Dict[str, float]:
    """Modeled bytes SENT per device per sync on the rs-ag wire path.

    Each endpoint ships E−1 of its E payload slots on the reduce-scatter
    leg and its one re-quantized reduced slot to the E−1 peers on the
    all-gather leg: ``(E−1)/E · P_wire`` per leg, ``2·(E−1)/E · P_wire``
    total — versus the gather-based wire exchange's ``(E−1) · P_wire``
    per device (``measured_cross_domain_bytes``), a 2/E ratio.
    """
    per = n_params * payload_bytes_per_param(bits, block)
    e = max(int(endpoints), 1)
    leg = per * (e - 1) / e
    return {
        "rs_bytes_per_device": leg,
        "ag_bytes_per_device": leg,
        "rs_ag_bytes_per_device": 2.0 * leg,
    }


def outer_comm_time(n_params: float, n_devices: int, chip: Chip,
                    group_size: int, *, bits: int = 32, block: int = 256,
                    hierarchical: bool = False, pods: int = 1,
                    sharded: bool = False) -> float:
    """Ring all-reduce of the Δθ payload across the slow domain.

    Hierarchical: full-precision psum over the fast intra-pod domain first
    (costed at intra_group_bw), then the compressed exchange over the pod
    endpoints (inter_group_bw). Sharded (DESIGN.md §10): each of the
    ``group_size`` device lanes exchanges only its 1/group_size shard of
    the payload — the lanes run in parallel, so the exchange time divides
    by the shard count while the total wire traffic stays the same.
    """
    n_groups = max(n_devices // group_size, 1)
    per_param = payload_bytes_per_param(bits, block)
    shards = max(group_size, 1) if sharded else 1
    lane = n_params * per_param / shards
    if hierarchical and pods > 1:
        groups_per_pod = max(n_groups // pods, 1)
        t_intra = _allreduce_t(n_params * 4.0 / shards, groups_per_pod,
                               chip.intra_group_bw)
        t_cross = _allreduce_t(lane, pods, chip.inter_group_bw)
        return t_intra + t_cross
    return _allreduce_t(lane, n_groups, chip.inter_group_bw)


def outer_update_time(n_params: float, chip: Chip) -> float:
    """One fused pass over θ/M/Δθ (read 3, write 2 fp32 streams)."""
    return 5 * n_params * 4.0 / chip.hbm_bw


def period_times(n_params: float, n_devices: int, chip: Chip, *,
                 sync_interval: int, sync_delay: int,
                 group_size: int = 4, bits: int = 32, block: int = 256,
                 hierarchical: bool = False, pods: int = 1,
                 comm_chunks: int = 1, sharded: bool = False,
                 rs_ag: bool = False) -> Dict[str, float]:
    t_inner = inner_step_time(n_params, n_devices, chip, group_size)
    t_comm = outer_comm_time(n_params, n_devices, chip, group_size,
                             bits=bits, block=block,
                             hierarchical=hierarchical, pods=pods,
                             sharded=sharded)
    t_upd = outer_update_time(n_params, chip)
    if comm_chunks > 1:
        # chunked dispatch pipelines quantize/update against the exchange
        t_dispatch = (max(t_comm, t_upd)
                      + min(t_comm, t_upd) / comm_chunks)
    else:
        t_dispatch = t_comm + t_upd
    exposed = max(0.0, t_comm - sync_delay * t_inner)
    eager = sync_interval * t_inner + t_dispatch
    overlap = sync_interval * t_inner + exposed + (t_dispatch - t_comm)
    dstar = 0 if t_inner <= 0 else int(-(-t_comm // t_inner))  # ceil
    n_groups = max(n_devices // group_size, 1)
    bytes_cross = cross_domain_bytes(
        n_params, n_groups=n_groups, pods=pods, bits=bits, block=block,
        hierarchical=hierarchical)
    bytes_flat = cross_domain_bytes(n_params, n_groups=n_groups)

    # Per-phase accounting (DESIGN.md §9). Warmup trains globally synced:
    # the gradient pmean crosses the group boundary every step (fp32, the
    # in-group leg is already inside t_inner), plus one params-pmean
    # accumulate per sync_interval — under the unified event engine that
    # accumulate overlaps the next sync_delay steps exactly like an outer
    # dispatch. Those steps are WARMUP steps (t_inner + the grad pmean
    # each), so the hiding budget per overlapped step is the full warmup
    # step time. Inner phase: only the (compressed) outer sync every
    # sync_interval, with the row's delay hiding it.
    t_grad_cross = _allreduce_t(n_params * 4.0, n_groups,
                                chip.inter_group_bw)
    acc_exposed = max(0.0, t_grad_cross
                      - sync_delay * (t_inner + t_grad_cross))
    warmup_comm_per_step = t_grad_cross + acc_exposed / sync_interval
    warmup_step = t_inner + warmup_comm_per_step
    inner_comm_per_step = exposed / sync_interval
    inner_step = t_inner + inner_comm_per_step
    grad_cross_bytes = 2.0 * n_params * 4.0 * (n_groups - 1)
    shards = max(group_size, 1) if sharded else 1
    rs_fields = {}
    if rs_ag:
        # each sharded lane exchanges its 1/shards of the payload over
        # the same n_groups endpoints; total-bytes fields above already
        # match (E endpoints × 2·(E−1)/E·P == the 2·P·(E−1) ring total)
        rs_fields = rs_ag_bytes_per_device(
            n_params / shards, endpoints=n_groups, bits=bits, block=block)
    return {
        **rs_fields,
        "t_inner": t_inner, "t_comm": t_comm, "t_update": t_upd,
        "eager": eager, "overlap": overlap,
        "reduction": 1.0 - overlap / eager,
        "exposed_frac": exposed / max(t_comm, 1e-30),
        "d_star": min(dstar, sync_interval - 1),
        "bytes_cross_per_sync": bytes_cross,
        # sharded exchange: each device lane carries 1/shards of the
        # payload (the total above is the sum over lanes)
        "shards": shards,
        "per_device_bytes_cross_per_sync": bytes_cross / shards,
        "bytes_flat_fp32": bytes_flat,
        "bytes_reduction": bytes_flat / max(bytes_cross, 1e-30),
        # per-phase comm fractions + bytes (consumed by the bench-models
        # CI job): cross-domain comm time / total step time in each phase
        "warmup_comm_fraction": warmup_comm_per_step / max(warmup_step,
                                                           1e-30),
        "inner_comm_fraction": inner_comm_per_step / max(inner_step,
                                                         1e-30),
        "warmup_bytes_cross_per_step":
            grad_cross_bytes + grad_cross_bytes / sync_interval,
        "inner_bytes_cross_per_step": bytes_cross / sync_interval,
    }


def resolve_sync_delay(*, n_params: float, n_devices: int, group_size: int,
                       sync_interval: int, chip: Optional[str] = None,
                       bits: int = 32, block: int = 256,
                       hierarchical: bool = False,
                       pods: int = 1) -> Optional[int]:
    """d* for ``sync_delay="auto"`` — the smallest delay that fully hides
    the (possibly compressed, hierarchical) outer collective. ``None``
    when the model has no estimate (no chip hint, or — with a warning
    rather than a mid-run crash — an unknown one; callers fall back to
    eager, d*=0)."""
    if not chip:
        return None
    if chip not in CHIPS:
        warnings.warn(
            f"unknown chip {chip!r} for sync_delay resolution "
            f"(known: {', '.join(sorted(CHIPS))}); falling back to "
            f"eager (d*=0)", stacklevel=2)
        return None
    r = period_times(
        n_params, n_devices, CHIPS[chip],
        sync_interval=sync_interval, sync_delay=0, group_size=group_size,
        bits=bits, block=block, hierarchical=hierarchical, pods=pods)
    return int(r["d_star"])
