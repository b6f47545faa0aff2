"""KV-page streaming between replica pools: the disaggregation wire
(port of ``hetu_tpu.serving.cluster.transport``).

Disaggregated serving runs prefill and decode on DIFFERENT engines: a
prefill replica computes the prompt's KV pages, the pages move to a
decode replica's pool, and generation resumes there.
:class:`PageTransport` is the interface that move goes through, in two
phases:

* :meth:`~PageTransport.extract` stages the source pages on the host
  the instant the prefill finishes, while the pages are still owned; the
  source engine is then free to retire them into its prefix cache.
* :meth:`~PageTransport.inject` lands the staged pages in
  already-allocated destination pages and records the handoff.

:class:`LocalPageTransport` is the process-local implementation.  It
copies page contents bit for bit (the decode replica reads the KV a
monolithic engine would hold), writing them into the destination pool's
own page tensors in place, by index: a captured serving step reads those
tensors, so they are never rebound.  The wire cost the copy stands in
for is priced through the cost model's one
:func:`~hetu_tpu_torch.planner.cost_model.collective_time` (the
point-to-point rate: a prefill->decode page stream is a send, not a
collective), on an H100 SXM cluster by default.  Every handoff therefore
carries a **priced edge claim**: a ``CommEdge``-shaped dict plus the
predicted seconds on the modelled interconnect, beside the measured
``wall_s`` of the copy.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..kv_pool import PagedKVPool, protocol_seq


class PageTransport:
    """Interface for moving KV pages between replica pools.

    Implementations must be bit-exact (the disaggregation correctness
    contract rides on it) and must append a priced handoff record per
    :meth:`inject` (see :class:`LocalPageTransport` for the record)."""

    def extract(self, src_pool: PagedKVPool,
                src_pages: Sequence[int]) -> Any:
        raise NotImplementedError

    def inject(self, dst_pool: PagedKVPool, staged: Any,
               dst_pages: Sequence[int], src_replica: int = -1,
               dst_replica: int = -1,
               epoch: Optional[int] = None) -> Dict[str, Any]:
        raise NotImplementedError

    def records_for(self, dst_replica: int) -> List[Dict[str, Any]]:
        raise NotImplementedError


class LocalPageTransport(PageTransport):
    """Process-local page copy with alpha-beta wire pricing.

    ``cluster_spec`` (a :class:`~hetu_tpu_torch.planner.cost_model.
    ClusterSpec`, H100 SXM by default) models the interconnect the
    handoff would cross; the predicted seconds use its point-to-point
    rate.  Each record also carries the measured wall time of the copy
    (host to device, the scatter into the pool included)."""

    def __init__(self, cluster_spec=None):
        if cluster_spec is None:
            from ...planner.cost_model import ClusterSpec
            cluster_spec = ClusterSpec()
        self.cluster_spec = cluster_spec
        self.records: List[Dict[str, Any]] = []
        # wire.extract events ``(seq, src_pages)`` for the protocol
        # verifier: extraction reads the source pages
        self.extract_log: List[Any] = []

    # -- the two wire phases -------------------------------------------------

    def extract(self, src_pool: PagedKVPool,
                src_pages: Sequence[int]) -> Dict[str, Any]:
        """Copy ``src_pages`` off the source pool into host tensors (one
        ``[n, page, ...]`` tensor per layer per k/v page stack), so the
        source engine may free or retire the pages the moment this
        returns.  ``wall_s`` is the copy's measured time."""
        idx_list = [int(p) for p in src_pages]
        self.extract_log.append((protocol_seq(), tuple(idx_list)))
        t0 = time.perf_counter()
        dev = src_pool.k_pages[0].device
        idx = torch.tensor(idx_list, dtype=torch.long, device=dev)
        k = [p.index_select(0, idx).cpu() for p in src_pool.k_pages]
        v = [p.index_select(0, idx).cpu() for p in src_pool.v_pages]
        wall = time.perf_counter() - t0
        return {"k": k, "v": v, "n_pages": len(idx_list),
                # page_bytes is summed from the pool's own tensors, so a
                # latent or quantized pool's smaller pages are priced at
                # their true wire size
                "payload_bytes": len(idx_list) * src_pool.page_bytes,
                "layout": src_pool.layout_tag, "wall_s": wall}

    def inject(self, dst_pool: PagedKVPool, staged: Dict[str, Any],
               dst_pages: Sequence[int], src_replica: int = -1,
               dst_replica: int = -1,
               epoch: Optional[int] = None) -> Dict[str, Any]:
        """Land staged pages in ``dst_pages`` (already allocated in
        ``dst_pool``), in place, and append the priced handoff record.
        ``epoch`` is the fence token: the cluster's per-handoff staging
        epoch (fresh on every re-stage); it has no usable default, so a
        call site that omits it records ``epoch: None``."""
        idx_list = [int(p) for p in dst_pages]
        if len(idx_list) != int(staged["n_pages"]):
            raise ValueError(
                f"staged {staged['n_pages']} pages but got "
                f"{len(idx_list)} destination pages")
        src_layout = staged.get("layout")
        if src_layout is not None and \
                src_layout != dst_pool.layout_tag:
            # bit-exactness is the handoff contract: page bytes of another
            # layout (latent vs full-head, other quant or geometry) are
            # not the destination's KV, even when shapes broadcast
            raise ValueError(
                f"page layout mismatch: staged {src_layout} vs "
                f"destination pool {dst_pool.layout_tag}")
        dev = dst_pool.k_pages[0].device
        t0 = time.perf_counter()
        idx = torch.tensor(idx_list, dtype=torch.long, device=dev)
        for pages, rows in ((dst_pool.k_pages, staged["k"]),
                            (dst_pool.v_pages, staged["v"])):
            for p, s in zip(pages, rows):
                p.index_copy_(0, idx, s.to(dev))
        if dev.type == "cuda":          # the wall time holds the copy
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        rec = self._price(int(staged["n_pages"]),
                          int(staged["payload_bytes"]),
                          src_replica, dst_replica, wall)
        rec["epoch"] = None if epoch is None else int(epoch)
        rec["seq"] = protocol_seq()
        self.records.append(rec)
        return rec

    # -- pricing -------------------------------------------------------------

    def _price(self, n_pages: int, payload_bytes: int, src: int,
               dst: int, wall_s: float) -> Dict[str, Any]:
        """The priced edge claim: a CommEdge-shaped dict (kind / payload /
        count / tag) plus the alpha-beta predicted seconds."""
        from ...planner.cost_model import collective_time
        edge = {"kind": "ppermute", "tensor": "kv_pages",
                "producer": f"prefill r{src}",
                "consumer": f"decode r{dst}",
                "src_spec": f"pool@r{src}", "dst_spec": f"pool@r{dst}",
                "axes": ("replica",), "payload_bytes": payload_bytes,
                "count": 1, "tag": "kv_handoff", "origin": "declared"}
        predicted_s = collective_time("ppermute", float(payload_bytes),
                                      2, self.cluster_spec)
        return {"src": int(src), "dst": int(dst), "pages": n_pages,
                "payload_bytes": payload_bytes, "edge": edge,
                "predicted_s": float(predicted_s),
                "wall_s": float(wall_s)}

    def records_for(self, dst_replica: int) -> List[Dict[str, Any]]:
        """The handoff records landing on ``dst_replica``."""
        return [r for r in self.records if r["dst"] == int(dst_replica)]

    @property
    def total_payload_bytes(self) -> int:
        return sum(r["payload_bytes"] for r in self.records)

    @property
    def total_predicted_s(self) -> float:
        return sum(r["predicted_s"] for r in self.records)
