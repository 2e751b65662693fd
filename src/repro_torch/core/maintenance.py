"""Dataset maintenance engine: background jobs over the manifest catalog.

Three jobs keep a long-lived lakehouse dataset healthy (the paper's
petabyte-catalog story needs all three; Delta/Iceberg call them statistics
collection, checkpointing, and vacuum):

``backfill_stats``
    Computes :class:`~repro.core.chunks.ChunkStats` sidecars for chunks
    that predate the stats format, by decoding each uncovered
    chunk once — tiled samples are reassembled from their tiles so the
    backfilled bounds are *exact*.  Records that exist but predate the
    membership sketches (``sketched=False``) are recomputed the
    same way, so legacy datasets gain ``=``/``IN``/``CONTAINS`` prune
    verdicts too (``sketches_lifted`` in the report; the planner's
    ``ScanPlan.sketch_coverage`` shows the remaining gap).  After a
    backfill, the TQL planner prunes a pre-stats dataset exactly like a
    natively-written one, and query results are byte-identical (stats
    are an optimization, never a correctness input — this job only
    tightens the planner's intervals).

``compact_manifest``
    Folds the manifest's delta-segment chain — plus any stale or
    never-covered nodes re-read from the loose per-file layout — into one
    fresh consolidated segment and collapses the pointer to it (the
    Delta-checkpoint pattern).  Legacy datasets without a manifest adopt
    one here.  Node snapshots are rebuilt through
    :meth:`VersionControl.node_snapshot`, which now derives the manifest's
    **column-statistics section** (format v2) from each tensor's encoder +
    stats sidecar — so compaction is also how a legacy or pre-v2 dataset
    gains plan-at-open: after it, TQL ``WHERE`` planning runs from the
    2-request cold open with zero tensor binds (run ``backfill_stats``
    first on pre-stats datasets so the lifted section carries real
    bounds).  After compaction a cold ``Dataset`` open costs exactly two
    requests: pointer + one segment.  Superseded segment objects are left
    on storage on purpose (a reader that fetched the old pointer a moment
    ago may still be reading them) and become orphans for the GC.

``gc_orphans``
    Mark-and-sweep of unreachable objects.  **Reachability rule**: a chunk
    object ``versions/{node}/tensors/{t}/chunks/{name}`` is *live* iff its
    node is in the commit tree AND some commit node whose schema contains
    ``t`` references ``name`` in its ``chunk_set`` (chunks + tile chunks
    are registered at their creation node) or its chunk-encoder snapshot
    (covers chunks whose chunk_set entry was lost mid-crash — the encoder
    still resolves them, so deleting would break reads).  A manifest
    segment is live iff the pointer references it.  Any key under a node
    directory absent from the commit tree is dead.  Everything else under
    ``versions/`` (state files of scheduled tensors) is never touched.
    Orphans come from crashed flushes, ``delete_tensor`` leftovers,
    superseded manifest segments, and aborted branches.  The job defaults
    to ``dry_run=True`` and reports what it *would* delete; the sweep is
    the only destructive operation in this module and is conservative by
    construction: *unknown means live*.

All jobs flush the dataset first so in-memory state (open chunk builders,
pending diffs) is on storage before any scan, and all report through
:class:`MaintenanceReport` so callers/benchmarks can assert budgets.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import chunks as chunklib
from . import fetch
from .chunk_encoder import ChunkEncoder
from .chunks import _StatsAccumulator
from .codecs import get_codec
from .manifest import SEGMENT_PREFIX, Manifest
from .storage import StorageError
from .tensor import Tensor
from .tiling import TileDescriptor, assemble_from_tiles

_CHUNK_KEY_RE = re.compile(
    r"^versions/(?P<node>[^/]+)/tensors/(?P<tensor>.+)/chunks/(?P<name>[^/]+)$")
_NODE_KEY_RE = re.compile(r"^versions/(?P<node>[^/]+)/")

JOBS = ("backfill_stats", "compact_manifest", "gc_orphans")


@dataclass
class MaintenanceReport:
    """Outcome of one maintenance job."""

    job: str
    dry_run: bool
    #: keys the job wrote/deleted (or would, under dry_run)
    actions: List[str] = field(default_factory=list)
    #: job-specific counters (chunks backfilled, bytes reclaimed, ...)
    details: Dict[str, int] = field(default_factory=dict)

    def summary(self) -> str:
        det = ", ".join(f"{k}={v}" for k, v in sorted(self.details.items()))
        tag = " (dry-run)" if self.dry_run else ""
        return f"{self.job}{tag}: {len(self.actions)} actions; {det}"


class MaintenanceRunner:
    """Job runner bound to one :class:`~repro.core.dataset.Dataset`."""

    def __init__(self, ds) -> None:
        self.ds = ds

    def run(self, jobs: Sequence[str] = JOBS, *,
            dry_run: bool = False) -> List[MaintenanceReport]:
        out = []
        for job in jobs:
            if job not in JOBS:
                raise ValueError(f"unknown maintenance job {job!r}; "
                                 f"have {JOBS}")
            out.append(getattr(self, job)(dry_run=dry_run))
        return out

    # ------------------------------------------------------- stats backfill
    def backfill_stats(self, ref: Optional[str] = None, *,
                       dry_run: bool = False) -> MaintenanceReport:
        """Compute missing ChunkStats sidecars for one version (default:
        the current node).  Decodes each stat-less chunk exactly once;
        tiled samples fetch + reassemble their tiles so bounds are exact.
        Pre-sketch records (``sketched=False``) are recomputed the same
        way so legacy datasets gain membership sketches.
        """
        ds = self.ds
        ds.flush()
        vc = ds.vc
        nid = vc.resolve_ref(ref) if ref else vc.current_id
        report = MaintenanceReport("backfill_stats", dry_run)
        engine = fetch.engine_for(vc.storage)
        chunks_done = 0
        sketches_lifted = 0
        for tname in vc.schema_tensors(nid):
            t = Tensor(tname, vc, node_id=nid)
            missing = []
            for n in t.encoder.chunk_names():
                st = t.stats.get(n)
                if st is None:
                    missing.append(n)
                elif not st.sketched:
                    missing.append(n)
                    sketches_lifted += 1
            if not missing:
                continue
            for cname in missing:
                key = vc.resolve_chunk_key(tname, cname, nid)
                t.stats.set(cname, self._compute_chunk_stats(t, key, engine))
                chunks_done += 1
            report.actions.append(vc.state_key(tname, "chunk_stats.json", nid))
            if not dry_run:
                vc.put_state(tname, "chunk_stats.json", t.stats.serialize(),
                             nid)
        if not dry_run and nid == vc.current_id:
            # live Tensor objects cached pre-backfill hold the stale (empty)
            # table; drop them so the planner sees the new sidecar
            ds._tensors.clear()
        report.details.update(chunks_backfilled=chunks_done,
                              sketches_lifted=sketches_lifted,
                              tensors_touched=len(report.actions))
        return report

    @staticmethod
    def _compute_chunk_stats(t: Tensor, key: str,
                             engine: "fetch.FetchEngine"):
        """Exact ChunkStats of one persisted chunk, from its payload."""
        raw = engine.fetch_full(key)
        header = chunklib.parse_header(raw)
        codec = get_codec(header.codec)
        dtype = np.dtype(header.dtype)
        acc = _StatsAccumulator(dtype)
        for i in range(header.num_samples):
            s, e = header.byte_range(i)
            payload = raw[s:e]
            try:
                if header.is_tiled(i):
                    desc = TileDescriptor.from_bytes(payload)
                    blobs = engine.fetch_many(
                        [t._chunk_key(nm) for nm in desc.chunk_names])
                    acc.observe(assemble_from_tiles(
                        desc, [blobs[t._chunk_key(nm)]
                               for nm in desc.chunk_names]))
                else:
                    acc.observe(codec.decode(payload, header.shapes[i],
                                             dtype))
            except Exception:
                acc.mark_inexact()
        return acc.snapshot(header.nbytes_data())

    # --------------------------------------------------- manifest compaction
    def compact_manifest(self, *, dry_run: bool = False) -> MaintenanceReport:
        """Fold delta segments + stale/uncovered nodes into one consolidated
        segment; adopt a manifest for legacy datasets."""
        ds = self.ds
        ds.flush()
        vc = ds.vc
        report = MaintenanceReport("compact_manifest", dry_run)
        adopted = vc.manifest is None
        segments_before = 0 if adopted else len(vc.manifest.segments)
        stale_before = 0 if adopted else len(vc.manifest.stale
                                             & set(vc.manifest.nodes))
        nodes = {nid: vc.node_snapshot(nid) for nid in vc.commits}
        report.details.update(
            nodes_folded=len(nodes), segments_folded=segments_before,
            stale_readopted=stale_before, adopted=int(adopted),
            # tensors whose scan index (chunk bounds + stats) was lifted
            # into the manifest's column-statistics section: plan-at-open
            # coverage after this compaction
            column_stats_lifted=sum(len(ns.stats) for ns in nodes.values()))
        if dry_run:
            return report
        if vc.manifest is None:
            vc.manifest = Manifest.create(vc.storage)
        seg_key = vc.manifest.replace_segments(nodes)
        # force: a freshly adopted pointer carries no version tree yet, and
        # without one the next cold open pays an extra vc_info GET
        vc.save_info(force=True)
        report.actions.append(seg_key)
        return report

    # -------------------------------------------------------- orphan-chunk GC
    def gc_orphans(self, *, dry_run: bool = True) -> MaintenanceReport:
        """Mark-and-sweep unreachable chunks / segments / node dirs.

        See the module docstring for the reachability rule.  Conservative:
        a chunk referenced by ANY node's chunk_set or encoder snapshot —
        for any node in the commit tree whose schema holds the tensor —
        survives, no matter which node directory stores it.
        """
        ds = self.ds
        ds.flush()
        vc = ds.vc
        storage = vc.storage
        report = MaintenanceReport("gc_orphans", dry_run)
        # ---- mark
        live_nodes = set(vc.commits)
        live_pairs: Set[Tuple[str, str]] = set()   # (tensor, chunk name)
        for nid in live_nodes:
            for tname in vc.schema_tensors(nid):
                for cname in vc.chunk_set(nid, tname):
                    live_pairs.add((tname, cname))
                enc_raw = vc.get_state(tname, "chunk_encoder", nid)
                if enc_raw:
                    for cname in ChunkEncoder.deserialize(enc_raw).chunk_names():
                        live_pairs.add((tname, cname))
        live_segments = set(vc.manifest.segments) if vc.manifest else set()
        # ---- sweep
        orphans: List[str] = []
        for key in storage.list_keys("versions/"):
            nm = _NODE_KEY_RE.match(key)
            if nm and nm.group("node") not in live_nodes:
                orphans.append(key)     # whole node dir fell off the tree
                continue
            cm = _CHUNK_KEY_RE.match(key)
            if cm and (cm.group("tensor"), cm.group("name")) not in live_pairs:
                orphans.append(key)
        for key in storage.list_keys(SEGMENT_PREFIX):
            if key not in live_segments:
                orphans.append(key)
        reclaimed = 0
        orphan_chunks = 0
        orphan_chunk_bytes = 0
        engine = fetch.engine_for(storage)
        for key in orphans:
            try:
                nb = storage.num_bytes(key)
            except StorageError:
                continue  # raced away already
            reclaimed += nb
            if _CHUNK_KEY_RE.match(key):
                # chunk-payload orphans specifically: the write-chaos bench
                # gates on these being ~0 after non-overlapping contention
                # (rebase grafts uploaded chunks instead of abandoning them)
                orphan_chunks += 1
                orphan_chunk_bytes += nb
            if not dry_run:
                storage.delete(key)
                engine.discard(key)
        report.actions = orphans
        report.details.update(
            chunks_live=len(live_pairs), orphans=len(orphans),
            orphan_chunks=orphan_chunks,
            orphan_chunk_bytes=orphan_chunk_bytes,
            bytes_reclaimed=reclaimed if not dry_run else 0,
            bytes_reclaimable=reclaimed)
        return report
