"""Dataset manifest: one-object catalogs for cold opens (§4.1 ACID commits).

The paper's lakehouse promise — ACID ingestion, time travel, petabyte
catalogs on object storage — needs a *consolidated* commit manifest: without
one, every cold ``Dataset`` open issues one GET per per-tensor state file
(meta, chunk encoder, sample ids, stats sidecar, chunk set, commit diff),
which is the dominant request class on small queries.  This module follows
the Delta-style consolidated-log design: a tiny *pointer* object that is
compare-and-swapped on every publication, plus immutable *segment* objects
holding complete per-node state snapshots.

Storage layout (keys relative to the dataset root)
--------------------------------------------------

::

    manifest.json                       # the POINTER (mutable, CAS-guarded)
    manifests/seg-{gen:08d}-{rand}.json # SEGMENTS (immutable, write-once)

Pointer schema::

    {"format":     "deeplake-repro-manifest-v2",
     "generation": <int, bumped by every successful CAS>,
     "segments":   [<segment key>, ...],   # newest first
     "vc":         {...} | null,           # version_control_info snapshot
     "stale":      [<node id>, ...]}       # nodes whose loose files win

Segment schema::

    {"format": "deeplake-repro-manifest-v2",
     "nodes": {<node id>: {"schema": [<tensor>, ...],
                           "tensors": {<tensor>: {<state file>: b64|null}},
                           "stats":   {<tensor>: {"last_idx": [...],
                                                  "chunks": [{...}|null]}}}}}

Each segment entry is a **complete snapshot of one commit node**: the raw
bytes of every per-tensor state file (``meta.json``, ``chunk_encoder``,
``sample_ids``, ``chunk_stats.json``, ``chunk_set.json``,
``commit_diff.json``), base64-encoded.  Folding segments newest-first with
whole-node replacement therefore reconstructs the catalog exactly; the
loose per-file layout stays on storage untouched, so legacy readers (and
the fallback path) always see a complete dataset.

Column-statistics section (format v2+, plan-at-open)
----------------------------------------------------

``"stats"`` is a decoded *scan index* per tensor: the chunk-boundary table
(``last_idx``, the encoder's inclusive last-global-index per chunk) plus
the per-chunk :class:`~repro.core.chunks.ChunkStats` records, in chunk-ord
order.  It duplicates information already inside the b64 ``chunk_encoder``
/ ``chunk_stats.json`` state bytes, but in a form
:func:`repro.core.tql.planner.plan_where` can consume directly — so a TQL
``WHERE`` on a committed dataset is planned straight from the 2-request
cold open, before any :class:`~repro.core.tensor.Tensor` binds.  The
section is optional everywhere: v1 segments (and nodes snapshotted without
decodable encoder bytes) simply lack it and readers fall back to binding
tensors.  v1 pointers/segments load unchanged; the first publication
rewrites the pointer as the current format.

Format v3 (membership sketches + top-k bounds)
----------------------------------------------

v3 extends each record of the column-statistics section with the chunk's
membership sketch — ``sketched`` / ``dom`` / ``dct`` / ``bloom``, wire
format and soundness rules in :mod:`repro.core.chunks` — which the planner
turns into ``=`` / ``IN`` / ``CONTAINS`` prune verdicts, and the executor's
``ORDER BY … LIMIT`` top-k scan reads the same records for its chunk-skip
bounds.  The node/segment/pointer *structure* is unchanged: v1 and v2
manifests still load (their records deserialize with ``sketched=False``,
so membership probes fall back to verify verdicts until ``backfill_stats``
+ ``compact_manifest`` lift the sketches), and a v3 reader folding a mixed
chain treats each record independently.

CAS protocol (optimistic concurrency)
-------------------------------------

Every pointer mutation goes through ``StorageProvider.cas`` with the last
observed pointer bytes as ``expected``:

* **commit** (`commit_update`): write the new segment object first (it is
  unreachable until published, so a crash leaves only an orphan for GC),
  then CAS the pointer with the segment prepended, the new version-tree
  snapshot, and the published nodes removed from ``stale``.  A lost CAS
  reloads the pointer; if another writer advanced *any* branch head in the
  meantime the commit raises :class:`ManifestConflict` — the paper's ACID
  ingestion semantics (exactly one concurrent committer wins).
  :meth:`VersionControl.commit <repro.core.version_control.VersionControl.commit>`
  catches the conflict and **rebases**: it reloads the pointer, grafts this
  writer's already-uploaded chunks onto the winner's head (cross-branch
  commits merge trees outright; same-branch commits relocate iff the two
  writers touched disjoint tensor sets), and re-CASes — so on
  non-overlapping contention only the pointer ever contends and no chunk
  is uploaded twice.  Overlapping writes surface a typed
  ``CommitContendedError`` after bounded attempts.
* **pointer-only updates** (`update_vc`, `mark_stale`) reload-merge-retry:
  they cannot invalidate another writer's publication, so losing the race
  just means reapplying the mutation to the fresh pointer.  ``update_vc``
  keeps the strict all-branches fence (it republishes the *whole* tree and
  would clobber unseen branches); ``mark_stale`` only fences on its own
  node having been sealed by a foreign commit, since adding a staleness
  flag can never invalidate anyone else's snapshot.

Write-path guarantees (hostile storage)
---------------------------------------

Segment objects are uploaded with
:meth:`StorageProvider.put_verified <repro.core.storage.StorageProvider.put_verified>`
(post-put length/digest verification + transient retry), so a torn upload
is detected and re-put before the pointer ever references it.  The pointer
CAS itself is wrapped in :func:`repro.core.storage.retry_transient`: an
injected 5xx on the conditional put (which dies *before* applying) is
retried with the same ``expected`` token, while a clean ``False`` return
means real contention and reloads.  Publication stays a **single CAS**, so
a writer crashing at any earlier point leaves only unreferenced objects
(segments, chunks, loose state) that the orphan GC reclaims — never a
partially-visible commit.

Staleness (write-ahead invalidation)
------------------------------------

Committed nodes never change, so their manifest snapshots are valid
forever.  The writable head *does* change between commits: before the
first loose state write to a node the manifest currently covers,
``VersionControl.put_state`` calls :meth:`Manifest.mark_stale`, which
CASes the node onto the pointer's ``stale`` list *before* the loose write
lands.  Readers treat stale nodes as uncovered and fall back to the loose
per-file layout, so a concurrently-opened ``Dataset`` can never read a
superseded snapshot.  The next commit republishes the node and clears the
flag.

Consolidation
-------------

``commit_update`` folds the whole in-memory catalog into a single
consolidated segment whenever the encoded payload stays under
``AUTO_CONSOLIDATE_BYTES`` or the delta chain exceeds
``MAX_DELTA_SEGMENTS`` (the Delta-checkpoint pattern); otherwise it
appends an incremental delta segment.  The ``compact_manifest``
maintenance job (:mod:`.maintenance`) performs the same fold on demand and
re-adopts stale/uncovered nodes from loose files.  Superseded segment
objects are left behind deliberately — they are unreachable from the
pointer and the orphan GC sweeps them.

Cold-open request budget
------------------------

Opening a manifest dataset costs ``1 (pointer GET) + len(segments)``
requests for *all* catalog state — ``ds_meta.json`` is implied by the
pointer's format marker and the version tree rides inside the pointer, so
a consolidated dataset opens in **2 requests** regardless of tensor count
(vs ``~2 + 6·n_tensors`` for the legacy layout).  Segment reads go through
:meth:`FetchEngine.fetch_many <repro.core.fetch.FetchEngine.fetch_many>`
so they are batched, observed by the engine's cost EWMA, and accounted in
``Manifest.open_stats``.
"""

from __future__ import annotations

import base64
import json
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Union

import numpy as np

from .chunks import ChunkStats
from .storage import StorageError, StorageProvider, retry_transient

MANIFEST_KEY = "manifest.json"
SEGMENT_PREFIX = "manifests/"
FORMAT = "deeplake-repro-manifest-v3"
#: readable formats: v1 predates the column-statistics section, v2 the
#: membership sketches inside it (both degrade gracefully, never fail)
COMPAT_FORMATS = ("deeplake-repro-manifest-v1",
                  "deeplake-repro-manifest-v2", FORMAT)

#: fold to a single consolidated segment while the payload stays this small
AUTO_CONSOLIDATE_BYTES = 4 << 20
#: ... or whenever the delta chain grows past this many segments
MAX_DELTA_SEGMENTS = 8
#: pointer CAS attempts for reload-merge-retry updates before giving up
CAS_RETRIES = 8


class ManifestConflict(RuntimeError):
    """A concurrent writer won the manifest-pointer CAS race."""


def _b64e(data: Optional[bytes]) -> Optional[str]:
    return None if data is None else base64.b64encode(data).decode("ascii")


def _b64d(s: Optional[str]) -> Optional[bytes]:
    return None if s is None else base64.b64decode(s.encode("ascii"))


@dataclass
class ColumnStats:
    """Manifest-resident scan index of one tensor (format v2).

    ``last_idx[i]`` is the inclusive last global sample index of chunk
    ``i`` (the chunk-encoder boundary table) and ``chunk_stats[i]`` its
    :class:`~repro.core.chunks.ChunkStats` record (None when the chunk
    predates the stats sidecar).  Together they are everything
    ``plan_where`` needs to classify chunk groups — no tensor bind, no
    storage request.
    """

    last_idx: np.ndarray
    chunk_stats: List[Optional[ChunkStats]]

    @property
    def num_samples(self) -> int:
        return int(self.last_idx[-1]) + 1 if len(self.last_idx) else 0

    @property
    def num_chunks(self) -> int:
        return len(self.last_idx)

    def ords_of(self, indices: Union[Sequence[int], np.ndarray]) -> np.ndarray:
        """Vectorized global-index -> chunk-ord map (the same
        implementation :meth:`ChunkEncoder.ords_of` uses, so the
        manifest-served planner path can never diverge from the
        bound-tensor path)."""
        from .chunk_encoder import ords_of_boundaries
        return ords_of_boundaries(self.last_idx, indices)

    def stats_of(self, chunk_ord: int) -> Optional[ChunkStats]:
        return self.chunk_stats[int(chunk_ord)]

    def to_json(self) -> dict:
        return {"last_idx": [int(x) for x in self.last_idx],
                "chunks": [None if s is None else s.to_json()
                           for s in self.chunk_stats]}

    @classmethod
    def from_json(cls, d: dict) -> "ColumnStats":
        return cls(
            last_idx=np.asarray(d.get("last_idx", []), dtype=np.int64),
            chunk_stats=[None if s is None else ChunkStats.from_json(s)
                         for s in d.get("chunks", [])])


@dataclass
class NodeState:
    """Complete state snapshot of one commit node: schema + raw state-file
    bytes per tensor (``None`` marks a file the node never wrote), plus the
    optional decoded column-statistics section (format v2)."""

    schema: List[str] = field(default_factory=list)
    tensors: Dict[str, Dict[str, Optional[bytes]]] = field(default_factory=dict)
    #: tensor -> ColumnStats; absent for v1 segments / undecodable state
    stats: Dict[str, ColumnStats] = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {"schema": list(self.schema),
               "tensors": {t: {f: _b64e(b) for f, b in files.items()}
                           for t, files in self.tensors.items()}}
        if self.stats:
            out["stats"] = {t: cs.to_json() for t, cs in self.stats.items()}
        return out

    @classmethod
    def from_json(cls, d: dict) -> "NodeState":
        return cls(schema=list(d.get("schema", [])),
                   tensors={t: {f: _b64d(s) for f, s in files.items()}
                            for t, files in d.get("tensors", {}).items()},
                   stats={t: ColumnStats.from_json(s)
                          for t, s in d.get("stats", {}).items()})


def _new_segment_key(generation: int) -> str:
    return f"{SEGMENT_PREFIX}seg-{generation:08d}-{uuid.uuid4().hex[:8]}.json"


class Manifest:
    """In-memory fold of the pointer + its segment chain for one dataset.

    Owned by :class:`~repro.core.version_control.VersionControl`; all
    catalog reads/writes route through it when present.  See the module
    docstring for the wire format and CAS protocol.
    """

    def __init__(self, storage: StorageProvider, pointer: dict,
                 pointer_raw: bytes, nodes: Dict[str, NodeState],
                 open_stats: Optional[Dict[str, int]] = None) -> None:
        self.storage = storage
        self.generation: int = int(pointer.get("generation", 0))
        self.segments: List[str] = list(pointer.get("segments", []))
        self.vc_info: Optional[dict] = pointer.get("vc")
        self.stale: Set[str] = set(pointer.get("stale", []))
        self.nodes = nodes
        self._pointer_raw = pointer_raw
        # branch heads as this writer last published or loaded them; every
        # vc-publishing update compares the persisted pointer against this
        # (NOT against the raw CAS token, which benign retries refresh) so
        # a foreign commit can never be silently clobbered
        self._observed_branches: Dict[str, str] = dict(
            (pointer.get("vc") or {}).get("branches", {}))
        #: request accounting of the open path (pointer + segment reads)
        self.open_stats: Dict[str, int] = open_stats or {"requests": 0,
                                                         "bytes": 0}

    # ------------------------------------------------------------- open path
    @classmethod
    def load(cls, storage: StorageProvider) -> Optional["Manifest"]:
        """Fold the pointer + segments into a catalog; None = no manifest.

        The segment chain is fetched as ONE :meth:`FetchEngine.fetch_many`
        batch (the manifest prefetch of the cold-open path); newer segments
        replace older ones whole-node.
        """
        raw = storage.get_or_none(MANIFEST_KEY)
        if raw is None:
            return None
        pointer = json.loads(raw.decode())
        if pointer.get("format") not in COMPAT_FORMATS:
            raise StorageError(f"unsupported manifest format: "
                               f"{pointer.get('format')!r}")
        counters = {"requests": 1, "bytes": len(raw)}
        nodes: Dict[str, NodeState] = {}
        seg_keys = list(pointer.get("segments", []))
        if seg_keys:
            from . import fetch  # lazy: keep storage-only users import-light
            blobs = fetch.engine_for(storage).fetch_many(seg_keys,
                                                         counters=counters)
            for key in reversed(seg_keys):  # oldest first; newest wins
                seg = json.loads(blobs[key].decode())
                for nid, nd in seg.get("nodes", {}).items():
                    nodes[nid] = NodeState.from_json(nd)
        return cls(storage, pointer, raw, nodes, open_stats=counters)

    @classmethod
    def create(cls, storage: StorageProvider) -> "Manifest":
        """Bootstrap an empty manifest pointer (brand-new dataset).

        Races with a concurrent creator resolve by loading theirs.
        """
        pointer = {"format": FORMAT, "generation": 0, "segments": [],
                   "vc": None, "stale": []}
        raw = json.dumps(pointer, sort_keys=True).encode()
        if retry_transient(lambda: storage.cas(MANIFEST_KEY, raw, None),
                           what=MANIFEST_KEY):
            return cls(storage, pointer, raw, {})
        existing = cls.load(storage)
        assert existing is not None
        return existing

    # ------------------------------------------------------------- coverage
    def covers(self, node_id: str) -> bool:
        """True when the manifest snapshot of ``node_id`` is authoritative
        (present and not invalidated by a loose write)."""
        return node_id in self.nodes and node_id not in self.stale

    def node_schema(self, node_id: str) -> Optional[List[str]]:
        ns = self.nodes.get(node_id)
        return None if ns is None else list(ns.schema)

    def state_bytes(self, node_id: str, tensor: str,
                    fname: str) -> Optional[bytes]:
        """Raw bytes of one state file from the covered snapshot (None when
        the node never wrote it — an authoritative miss, not a fallback)."""
        ns = self.nodes.get(node_id)
        if ns is None:
            return None
        return ns.tensors.get(tensor, {}).get(fname)

    def column_stats(self, node_id: str,
                     tensor: str) -> Optional[ColumnStats]:
        """The covered snapshot's scan index of one tensor, or None when
        the node is uncovered/stale or the segment predates format v2 —
        callers then fall back to binding the tensor."""
        if not self.covers(node_id):
            return None
        return self.nodes[node_id].stats.get(tensor)

    # ------------------------------------------------------- pointer updates
    def _pointer_dict(self) -> dict:
        return {"format": FORMAT, "generation": self.generation,
                "segments": list(self.segments), "vc": self.vc_info,
                "stale": sorted(self.stale)}

    def _apply_pointer(self, pointer: dict, raw: bytes) -> None:
        self.generation = int(pointer.get("generation", 0))
        self.segments = list(pointer.get("segments", []))
        self.vc_info = pointer.get("vc")
        self.stale = set(pointer.get("stale", []))
        self._pointer_raw = raw

    def _cas_update(self, mutate: Callable[[dict], dict],
                    what: str) -> None:
        """Reload-merge-retry pointer update: ``mutate`` receives the
        freshest pointer dict and returns the successor (it may raise
        :class:`ManifestConflict` when its preconditions broke)."""
        expected = self._pointer_raw
        pointer = json.loads(expected.decode())
        for _ in range(CAS_RETRIES):
            new_pointer = mutate(pointer)
            new_pointer["generation"] = int(pointer.get("generation", 0)) + 1
            raw = json.dumps(new_pointer, sort_keys=True).encode()
            # injected 5xx dies before applying, so retrying with the same
            # expected token is safe; False means real contention
            if retry_transient(
                    lambda: self.storage.cas(MANIFEST_KEY, raw, expected),
                    what=MANIFEST_KEY):
                self._apply_pointer(new_pointer, raw)
                return
            expected = retry_transient(  # lost: reload (transients retried)
                lambda: self.storage.get(MANIFEST_KEY), what=MANIFEST_KEY)
            pointer = json.loads(expected.decode())
        raise ManifestConflict(
            f"manifest pointer update ({what}) lost the CAS race "
            f"{CAS_RETRIES} times")

    def _check_branches(self, pointer: dict, what: str) -> None:
        """Raise :class:`ManifestConflict` when the persisted pointer shows
        branch heads this writer has never observed (a foreign commit)."""
        cur = (pointer.get("vc") or {}).get("branches", {})
        if cur and cur != self._observed_branches:
            raise ManifestConflict(
                f"{what} lost: a concurrent writer moved a branch head "
                f"(persisted {cur}, last observed {self._observed_branches})")

    def update_vc(self, vc_info: dict) -> None:
        """Publish a new version-tree snapshot (checkout, flush, ...).
        Conflicts with a concurrent committer rather than clobbering it."""
        def mutate(p: dict) -> dict:
            self._check_branches(p, "vc publish")
            out = dict(p)
            out["vc"] = vc_info
            return out
        self._cas_update(mutate, "vc snapshot")
        self._observed_branches = dict(vc_info.get("branches", {}))

    def mark_stale(self, node_id: str, *, known_committed: bool = False) -> None:
        """Write-ahead invalidation: persist ``node_id`` onto the stale
        list BEFORE its first loose state write lands, so concurrent
        opens fall back to loose files instead of the dead snapshot.

        The update doubles as the conflict fence for the loose layout —
        but a *node-scoped* one: it raises :class:`ManifestConflict` only
        when the persisted pointer shows ``node_id`` itself was sealed by
        a foreign commit (the pending write would then clobber an
        immutable node's loose files).  Foreign movement of *other*
        branches is deliberately not a conflict here — adding a staleness
        flag cannot invalidate anyone else's publication, and deferring
        the cross-branch check to commit time is what lets
        ``VersionControl.commit`` rebase without re-uploading.  Callers
        that write to nodes they already know are sealed (maintenance
        backfill) pass ``known_committed=True`` to skip the fence.
        """
        self.stale.add(node_id)
        if node_id not in self.nodes:
            return  # never covered: nothing persisted to invalidate

        def mutate(p: dict) -> dict:
            if not known_committed:
                nd = ((p.get("vc") or {}).get("commits", {})).get(node_id)
                if nd and nd.get("committed"):
                    raise ManifestConflict(
                        f"stale mark of {node_id[:8]} lost: the node was "
                        f"sealed by a concurrent commit")
            out = dict(p)
            out["stale"] = sorted(set(p.get("stale", [])) | {node_id})
            return out
        self._cas_update(mutate, f"stale({node_id[:8]})")

    # ---------------------------------------------------------- publication
    def _encode_segment(self, nodes: Dict[str, NodeState]) -> bytes:
        return json.dumps(
            {"format": FORMAT,
             "nodes": {nid: ns.to_json() for nid, ns in nodes.items()}},
            sort_keys=True).encode()

    def _catalog_size_estimate(self) -> int:
        """Approximate encoded size of a consolidated segment, from raw
        state-file lengths (b64 is 4/3) — O(#files) len() calls, so the
        consolidate-vs-delta decision never serializes a catalog it is
        about to discard."""
        total = 64
        for ns in self.nodes.values():
            total += 96 + sum(len(t) + 8 for t in ns.schema)
            for t, files in ns.tensors.items():
                total += len(t) + 32
                for f, b in files.items():
                    total += len(f) + 16 + (0 if b is None else len(b) * 4 // 3)
            for t, cs in ns.stats.items():
                # ~20 chars per boundary int, ~220 per ChunkStats record
                total += len(t) + 32 + cs.num_chunks * 240
                for s in cs.chunk_stats:  # + the membership sketch payload
                    if s is None:
                        continue
                    if s.dct is not None:
                        total += 8 + sum(
                            (len(v) + 4) if isinstance(v, str) else 16
                            for v in s.dct)
                    if s.bloom:
                        total += len(s.bloom) + 16
        return total

    def commit_update(self, node_states: Dict[str, NodeState],
                      vc_info: dict, *, branch: str) -> str:
        """Atomically publish a commit: new segment + pointer swap.

        ``node_states`` are complete snapshots of the sealed node and the
        fresh head.  Publication is optimistic: if a pointer reload shows
        any branch head moved past what this writer last observed (another
        commit landed concurrently), :class:`ManifestConflict` is raised —
        the loose layout this commit already wrote stays readable, and the
        caller re-opens the dataset to retry.  Lost races against
        pointer-only updates (staleness marks, vc refreshes) are retried
        transparently.  Returns the published segment key.
        """
        self.nodes.update(node_states)
        self.stale -= set(node_states)
        if (self._catalog_size_estimate() <= AUTO_CONSOLIDATE_BYTES
                or len(self.segments) + 1 > MAX_DELTA_SEGMENTS):
            seg_bytes, seg_nodes = self._encode_segment(self.nodes), None
        else:  # large catalog: publish only the two changed nodes
            seg_bytes = self._encode_segment(node_states)
            seg_nodes = list(node_states)
        seg_key = _new_segment_key(self.generation + 1)
        # verified: a torn segment upload must never be published by the CAS
        self.storage.put_verified(seg_key, seg_bytes)  # unreachable until CAS

        def mutate(p: dict) -> dict:
            self._check_branches(p, f"commit on {branch!r}")
            out = dict(p)
            if seg_nodes is None:
                out["segments"] = [seg_key]  # checkpoint supersedes chain
            else:
                out["segments"] = [seg_key] + list(p.get("segments", []))
            out["vc"] = vc_info
            out["stale"] = sorted(set(p.get("stale", []))
                                  - set(node_states))
            return out

        self._cas_update(mutate, f"commit({branch})")
        self._observed_branches = dict(vc_info.get("branches", {}))
        return seg_key

    def replace_segments(self, nodes: Dict[str, NodeState]) -> str:
        """Publish a consolidated segment covering ``nodes`` and collapse
        the pointer's chain to it (manifest compaction).  Stale flags of
        re-adopted nodes are cleared.  Returns the new segment key."""
        self.nodes = dict(nodes)
        seg_bytes = self._encode_segment(self.nodes)
        seg_key = _new_segment_key(self.generation + 1)
        self.storage.put_verified(seg_key, seg_bytes)

        def mutate(p: dict) -> dict:
            out = dict(p)
            out["segments"] = [seg_key]
            out["stale"] = sorted(set(p.get("stale", [])) - set(nodes))
            return out
        self._cas_update(mutate, "compaction")
        return seg_key
