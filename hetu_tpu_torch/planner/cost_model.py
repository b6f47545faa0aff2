"""Chip and cluster cost model: the part of ``hetu_tpu.planner.cost_model``
that the serving cluster's page transport and host KV tier price
through (``ChipSpec``, ``ClusterSpec`` and the alpha-beta collective
formulas, ``collective_time`` their one entry point).  The layer specs,
the roofline and the solver come with the planner (ROADMAP queue 1
item 16).

The port's default chip is the NVIDIA H100 SXM, from NVIDIA's published
H100 Tensor Core GPU datasheet (H100 SXM column): 80 GB of HBM3 at
3.35 TB/s, 989 TFLOP/s dense bf16 on the tensor cores (1,979 with
sparsity), and NVLink 4 at 900 GB/s a GPU (both directions together:
450 GB/s each way, to any peer through the NVSwitch fabric).  Between
nodes each GPU of a DGX H100 has one ConnectX-7 port at 400 Gb/s
(50 GB/s).  The fields keep the JAX model's names: ``ici_*`` is the
intra-node fabric (NVLink), ``dcn_*`` the network between nodes.  The
link latencies are the JAX model's assumptions, not datasheet figures.

All sizes in bytes, times in seconds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class ChipSpec:
    """Per-chip hardware parameters (default: H100 SXM, datasheet)."""
    name: str = "h100_sxm"
    peak_flops: float = 989e12      # dense bf16 FLOP/s
    hbm_bytes: float = 80e9
    hbm_bw: float = 3.35e12         # bytes/s
    # NVLink 4: 900 GB/s a GPU in both directions, 450 GB/s each way;
    # the NVSwitch gives every peer the whole rate, so it counts as ONE
    # link pair (all_to_all_time divides by ici_links // 2)
    ici_bw: float = 450e9           # bytes/s, one direction
    ici_links: int = 2
    ici_latency: float = 1e-6
    dcn_bw: float = 50e9            # ConnectX-7, 400 Gb/s a GPU
    dcn_latency: float = 10e-6


@dataclasses.dataclass
class ClusterSpec:
    """A (possibly multi-node) cluster: ``num_chips`` a node joined by the
    intra-node fabric, nodes joined by the network.

    ``link_alpha_beta`` optionally carries MEASURED per-collective
    ``(alpha, beta)`` fits (keys all_reduce / all_gather / reduce_scatter
    / all_to_all / p2p); a kind with a fit is priced ``alpha + beta *
    bytes`` instead of by the datasheet ring model."""
    chip: ChipSpec = dataclasses.field(default_factory=ChipSpec)
    num_chips: int = 8
    num_slices: int = 1
    link_alpha_beta: Optional[Dict[str, Tuple[float, float]]] = None

    @property
    def total_chips(self) -> int:
        return self.num_chips * self.num_slices

    def bw_for_group(self, group_size: int) -> Tuple[float, float]:
        """(bandwidth, latency) of the slowest hop a collective over
        ``group_size`` chips crosses: the intra-node fabric if it fits
        in one node, else the network."""
        if group_size <= self.num_chips:
            return self.chip.ici_bw, self.chip.ici_latency
        return self.chip.dcn_bw, self.chip.dcn_latency

    def measured(self, kind: str,
                 group_size: int = 1) -> Optional[Tuple[float, float]]:
        """The measured (alpha, beta) fit for ``kind``, or None when there
        is no fit OR the group spans nodes (a fit taken inside one node
        would underprice the network)."""
        if not self.link_alpha_beta or group_size > self.num_chips:
            return None
        return self.link_alpha_beta.get(kind)


# ---------------------------------------------------------------------------
# collective costs (alpha-beta / ring models): the one implementation
# ---------------------------------------------------------------------------
# Payload bytes are WIRE bytes: a quantized transport passes its narrow
# payload here.

def all_reduce_time(bytes_: float, n: int, cluster: ClusterSpec) -> float:
    if n <= 1:
        return 0.0
    m = cluster.measured("all_reduce", n)
    if m is not None:
        return m[0] + m[1] * bytes_
    bw, lat = cluster.bw_for_group(n)
    return 2.0 * (n - 1) / n * bytes_ / bw + 2 * (n - 1) * lat


def all_gather_time(bytes_: float, n: int, cluster: ClusterSpec,
                    _kind: str = "all_gather") -> float:
    """bytes_ = full (gathered) size."""
    if n <= 1:
        return 0.0
    m = cluster.measured(_kind, n)
    if m is not None:
        return m[0] + m[1] * bytes_
    bw, lat = cluster.bw_for_group(n)
    return (n - 1) / n * bytes_ / bw + (n - 1) * lat


def reduce_scatter_time(bytes_: float, n: int,
                        cluster: ClusterSpec) -> float:
    """bytes_ = full (pre-scatter) size."""
    return all_gather_time(bytes_, n, cluster, _kind="reduce_scatter")


def all_to_all_time(bytes_: float, n: int, cluster: ClusterSpec) -> float:
    if n <= 1:
        return 0.0
    m = cluster.measured("all_to_all", n)
    if m is not None:
        return m[0] + m[1] * bytes_
    bw, lat = cluster.bw_for_group(n)
    return (n - 1) / n * bytes_ / bw / max(1, cluster.chip.ici_links // 2) \
        + (n - 1) * lat


def p2p_time(bytes_: float, cluster: ClusterSpec,
             cross_slice: bool = False) -> float:
    m = cluster.measured("p2p", 2)
    if m is not None and not cross_slice:
        return m[0] + m[1] * bytes_
    bw = cluster.chip.dcn_bw if cross_slice else cluster.chip.ici_bw
    lat = cluster.chip.dcn_latency if cross_slice else cluster.chip.ici_latency
    return bytes_ / bw + lat


def collective_time(kind: str, bytes_: float, n: int,
                    cluster: ClusterSpec) -> float:
    """Alpha-beta time of ONE collective of ``kind`` moving ``bytes_``
    payload over a group of ``n`` chips.  ``reshard`` is priced at the
    all-to-all rate; ``scatter`` / ``identity`` move nothing."""
    if kind in ("all_reduce", "broadcast", "reduce"):
        return all_reduce_time(bytes_, n, cluster)
    if kind == "all_gather":
        return all_gather_time(bytes_, n, cluster)
    if kind == "reduce_scatter":
        return reduce_scatter_time(bytes_, n, cluster)
    if kind in ("all_to_all", "reshard"):
        return all_to_all_time(bytes_, n, cluster)
    if kind == "ppermute":
        return p2p_time(bytes_, cluster)
    return 0.0
