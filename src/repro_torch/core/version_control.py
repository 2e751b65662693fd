"""Version control built into the storage format (§4.1).

Design follows the paper:

* the dataset directory holds a *version tree* file (``version_control_info.json``)
  with branches and commit nodes;
* each version (node) has its own sub-directory with per-tensor state —
  chunk-encoder snapshot, sample ids, ``chunk_set`` (names of chunks CREATED
  in that version) and ``commit_diff`` (what changed);
* chunks never move: reading a chunk traverses the commit chain from the
  current node toward the root and stops at the first version whose
  chunk_set contains the chunk name.  A chunk_set may carry an ``"at"``
  home map (``{chunk_name: node_id}``) redirecting individual names to the
  directory they were *physically* uploaded under — the commit-rebase path
  uses it to graft already-uploaded chunks onto a relocated head without
  copying a byte (GC reachability is (tensor, name)-based and location-
  agnostic, so grafted chunks are never swept);
* every branch head is a *writable, uncommitted* node.  ``commit`` seals the
  head and opens a fresh child node (state files copied, chunk_set empty);
* sample ids (random u64 per appended row) keep identity across branches so
  ``merge`` can align rows.

Storage layout (keys relative to dataset root):

    version_control_info.json
    versions/{node}/schema.json                      # tensor list at this version
    versions/{node}/tensors/{t}/meta.json
    versions/{node}/tensors/{t}/chunk_encoder
    versions/{node}/tensors/{t}/chunk_stats.json
    versions/{node}/tensors/{t}/sample_ids
    versions/{node}/tensors/{t}/chunk_set.json
    versions/{node}/tensors/{t}/commit_diff.json
    versions/{node}/tensors/{t}/chunks/{chunk_name}

Manifest integration (:mod:`.manifest`): all per-tensor state reads and
writes route through :meth:`VersionControl.get_state` /
:meth:`VersionControl.put_state`.  When a dataset manifest is attached,
reads of manifest-covered nodes are served from the consolidated snapshot
(zero storage requests on a cold open); writes always land in the loose
per-file layout above (it stays complete and authoritative for legacy
readers) after write-ahead-invalidating the node's manifest snapshot.
``commit`` publishes complete snapshots of the sealed node and the fresh
head through one CAS pointer swap — the ACID ingestion point.

Concurrent committers (rebase-and-retry): losing the pointer swap no
longer surfaces a raw :class:`~repro.core.manifest.ManifestConflict`.
:meth:`VersionControl.commit` reloads the pointer and **rebases**:
commits on *different* branches merge version trees outright (nothing
re-uploaded, nothing relocated); commits racing on the *same* branch
relocate this writer's pending work onto a fresh head under the winner's
newest sealed node **iff** the two writers touched disjoint tensor sets
(cheap ``commit_diff`` intersection along the winner's path), grafting
already-uploaded chunks via the chunk_set ``"at"`` home map.  Overlapping
same-branch writes raise a typed :class:`CommitContendedError` (a
``ManifestConflict`` subclass) after bounded attempts.  All durable state
writes go through ``StorageProvider.put_verified`` so torn uploads are
detected and re-put before anything references them.
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from . import manifest as manifestlib
from . import telemetry
from .chunk_encoder import ChunkEncoder, ChunkStatsTable
from .storage import StorageError, StorageProvider

VC_INFO_KEY = "version_control_info.json"

#: bounded rebase attempts in :meth:`VersionControl.commit` before a
#: contended commit gives up with :class:`CommitContendedError`
COMMIT_REBASE_ATTEMPTS = 8


class CommitContendedError(manifestlib.ManifestConflict):
    """A commit could not be rebased onto the winning history: either the
    concurrent writers touched overlapping tensor sets on one branch, or
    the bounded rebase budget ran out.  Subclasses
    :class:`~repro.core.manifest.ManifestConflict` so existing conflict
    handlers keep working; the dataset itself is untouched — re-open a
    fresh handle and replay the writes to retry."""


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class CommitNode:
    id: str
    parent: Optional[str]
    branch: str
    message: Optional[str] = None
    committed: bool = False
    timestamp: float = 0.0
    children: List[str] = field(default_factory=list)

    def to_json(self) -> dict:
        # children is copied: serialized snapshots must not alias the live
        # list (save_info compares them against later state to skip no-ops)
        return {"id": self.id, "parent": self.parent, "branch": self.branch,
                "message": self.message, "committed": self.committed,
                "timestamp": self.timestamp, "children": list(self.children)}

    @classmethod
    def from_json(cls, d: dict) -> "CommitNode":
        return cls(d["id"], d["parent"], d["branch"], d.get("message"),
                   d.get("committed", False), d.get("timestamp", 0.0),
                   list(d.get("children", [])))


@dataclass
class CommitDiff:
    """What changed for one tensor within one version."""
    added_first: int = -1      # first appended global index (-1: none)
    added_count: int = 0
    updated: Set[int] = field(default_factory=set)
    created: bool = False      # tensor created in this version

    def record_append(self, first_idx: int, count: int) -> None:
        if self.added_count == 0:
            self.added_first = first_idx
        self.added_count += count

    def record_update(self, idx: int) -> None:
        # an update to a row appended in this same version is not a cross-
        # version update — it is still part of the "added" set
        if self.added_first != -1 and idx >= self.added_first:
            return
        self.updated.add(int(idx))

    def is_empty(self) -> bool:
        return self.added_count == 0 and not self.updated and not self.created

    def to_json(self) -> dict:
        return {"added_first": self.added_first, "added_count": self.added_count,
                "updated": sorted(self.updated), "created": self.created}

    @classmethod
    def from_json(cls, d: dict) -> "CommitDiff":
        return cls(d.get("added_first", -1), d.get("added_count", 0),
                   set(d.get("updated", [])), d.get("created", False))


class VersionControl:
    """Owns the version tree and per-node tensor state for one dataset."""

    # chunk_stats.json rides with the encoder snapshot: both key by chunk
    # name, so the copy stays valid in the child node (chunks never move).
    STATE_FILES = ("meta.json", "chunk_encoder", "sample_ids",
                   "chunk_stats.json")
    #: every per-tensor state file a commit-node snapshot must capture
    ALL_STATE_FILES = STATE_FILES + ("chunk_set.json", "commit_diff.json")

    def __init__(self, storage: StorageProvider,
                 manifest: Optional[manifestlib.Manifest] = None) -> None:
        self.storage = storage
        self.manifest = manifest
        self.branches: Dict[str, str] = {}
        self.commits: Dict[str, CommitNode] = {}
        self.current_id: str = ""
        # per current-node mutable state (flushed by save_info / tensor flush)
        self._chunk_sets: Dict[Tuple[str, str], Set[str]] = {}   # (node, tensor)
        self._schemas: Dict[str, List[str]] = {}                 # node -> tensor list
        self._diffs: Dict[str, CommitDiff] = {}                  # tensor -> diff (current node)
        # chunk relocation bookkeeping (commit rebase): per (node, tensor)
        # the "at" home map of names stored under another node's directory,
        # and per (tensor, name) the node a chunk was physically put under
        self._chunk_home_maps: Dict[Tuple[str, str], Dict[str, str]] = {}
        self._chunk_put_homes: Dict[Tuple[str, str], str] = {}
        #: commit-path observability: rebases (either shape), cross-branch
        #: adoptions, same-branch relocations, grafted chunks, contended
        #: failures.  Mirrored into the process-wide telemetry registry
        #: (``commit.*`` counters) so benches read one snapshot API.
        self.commit_stats: Dict[str, int] = {
            "commits": 0, "rebases": 0, "adoptions": 0, "relocations": 0,
            "grafted_chunks": 0, "contended": 0}
        # read-through/write-through memo of state-file bytes per
        # (node, tensor, fname); None records an authoritative miss
        self._state_cache: Dict[Tuple[str, str, str], Optional[bytes]] = {}
        # last version-tree snapshot this handle loaded or published; lets
        # save_info() skip the publication (and its conflict fence) when
        # nothing changed, so a read-only handle's flush never rolls back
        # or conflicts with a foreign commit
        self._saved_info: Optional[dict] = None
        self._load_or_init()

    # ------------------------------------------------------------------ setup
    def _load_or_init(self) -> None:
        m = self.manifest
        if m is not None and m.vc_info:
            # manifest-first open: the version tree rides inside the pointer
            d = m.vc_info
            self.branches = dict(d["branches"])
            self.commits = {k: CommitNode.from_json(v)
                            for k, v in d["commits"].items()}
            self.current_id = d["current"]
            self._saved_info = self._info_dict()
            self._load_current_diffs()
            return
        raw = self.storage.get_or_none(VC_INFO_KEY)
        if raw is None:
            root = CommitNode(id=_new_id(), parent=None, branch="main")
            self.commits = {root.id: root}
            self.branches = {"main": root.id}
            self.current_id = root.id
            self._put_json(self._schema_key(root.id), {"tensors": []})
            self._schemas[root.id] = []
            self.save_info()
        else:
            d = json.loads(raw.decode())
            self.branches = dict(d["branches"])
            self.commits = {k: CommitNode.from_json(v) for k, v in d["commits"].items()}
            self.current_id = d["current"]
            self._saved_info = self._info_dict()
            self._load_current_diffs()

    def _info_dict(self) -> dict:
        return {
            "branches": dict(self.branches),
            "commits": {k: v.to_json() for k, v in self.commits.items()},
            "current": self.current_id,
        }

    def save_info(self, sync_manifest: bool = True,
                  force: bool = False) -> None:
        """Persist the version tree.  No-op when nothing changed since the
        last load/publication — a read-only handle's flush neither pays a
        pointer CAS nor conflicts with (or rolls back) a foreign commit.
        On manifest datasets the pointer swap is the fence: the loose
        legacy mirror is only written AFTER the swap wins, mirroring
        :meth:`commit`'s ordering.  ``force`` republishes even an
        unchanged tree (a freshly adopted pointer has no vc yet)."""
        info = self._info_dict()
        if not force and info == self._saved_info:
            return
        if sync_manifest and self.manifest is not None:
            self.manifest.update_vc(info)  # conflict fence; raises on loss
        self._put_json(VC_INFO_KEY, info)
        self._saved_info = info

    # ------------------------------------------------------------- key helpers
    @staticmethod
    def node_dir(node_id: str) -> str:
        return f"versions/{node_id}"

    def _schema_key(self, node_id: str) -> str:
        return f"{self.node_dir(node_id)}/schema.json"

    def tensor_dir(self, node_id: str, tensor: str) -> str:
        return f"{self.node_dir(node_id)}/tensors/{tensor}"

    def state_key(self, tensor: str, fname: str, node_id: Optional[str] = None) -> str:
        return f"{self.tensor_dir(node_id or self.current_id, tensor)}/{fname}"

    def chunk_key(self, node_id: str, tensor: str, chunk_name: str) -> str:
        return f"{self.tensor_dir(node_id, tensor)}/chunks/{chunk_name}"

    def _put_json(self, key: str, obj) -> None:
        self.storage.put_verified(key, json.dumps(obj).encode())

    def _get_json(self, key: str, default=None):
        raw = self.storage.get_or_none(key)
        return default if raw is None else json.loads(raw.decode())

    # ------------------------------------------------------------- state I/O
    def get_state(self, tensor: str, fname: str,
                  node_id: Optional[str] = None) -> Optional[bytes]:
        """Bytes of one per-tensor state file, manifest-first.

        Manifest-covered nodes are served from the consolidated snapshot
        (including authoritative misses — a covered node that never wrote
        the file); everything else falls back to the loose per-file
        layout.  Reads memoize per (node, tensor, file).
        """
        nid = node_id or self.current_id
        ck = (nid, tensor, fname)
        if ck in self._state_cache:
            return self._state_cache[ck]
        m = self.manifest
        if m is not None and m.covers(nid):
            data = m.state_bytes(nid, tensor, fname)
        else:
            data = self.storage.get_or_none(self.state_key(tensor, fname, nid))
        self._state_cache[ck] = data
        return data

    def put_state(self, tensor: str, fname: str, data: bytes,
                  node_id: Optional[str] = None) -> None:
        """Write one state file to the loose layout (always authoritative),
        write-ahead-invalidating the node's manifest snapshot first so a
        concurrent cold open can never read the superseded snapshot."""
        nid = node_id or self.current_id
        m = self.manifest
        if m is not None and m.covers(nid):
            node = self.commits.get(nid)
            m.mark_stale(nid,
                         known_committed=bool(node and node.committed))
        self.storage.put_verified(self.state_key(tensor, fname, nid), data)
        self._state_cache[(nid, tensor, fname)] = bytes(data)

    def _get_state_json(self, tensor: str, fname: str,
                        node_id: Optional[str] = None, default=None):
        raw = self.get_state(tensor, fname, node_id)
        return default if raw is None else json.loads(raw.decode())

    def node_snapshot(self, node_id: str) -> manifestlib.NodeState:
        """Complete :class:`~repro.core.manifest.NodeState` of one node
        (schema + raw bytes of every state file of every tensor), including
        the decoded column-statistics section (manifest format v2) so the
        TQL planner can classify chunk groups straight from the cold-open
        pointer fold, before any tensor binds."""
        schema = self.schema_tensors(node_id)
        tensors = {
            t: {f: self.get_state(t, f, node_id) for f in self.ALL_STATE_FILES}
            for t in schema}
        stats: Dict[str, manifestlib.ColumnStats] = {}
        for t in schema:
            cs = self._column_stats_from_state(tensors[t])
            if cs is not None:
                stats[t] = cs
        return manifestlib.NodeState(schema=schema, tensors=tensors,
                                     stats=stats)

    @staticmethod
    def _column_stats_from_state(
            files: Dict[str, Optional[bytes]]
    ) -> Optional[manifestlib.ColumnStats]:
        """Decode a tensor's encoder + stats-sidecar bytes into the
        manifest's scan index (None when the encoder bytes are absent or
        unreadable — the section is an optimization, never load-bearing)."""
        enc_raw = files.get("chunk_encoder")
        if not enc_raw:
            return None
        try:
            enc = ChunkEncoder.deserialize(enc_raw)
        except Exception:
            return None
        st_raw = files.get("chunk_stats.json")
        try:
            table = ChunkStatsTable.deserialize(st_raw) if st_raw \
                else ChunkStatsTable()
        except Exception:
            table = ChunkStatsTable()
        names = enc.chunk_names()
        return manifestlib.ColumnStats(
            last_idx=np.asarray([enc.chunk_span(o)[1]
                                 for o in range(len(names))],
                                dtype=np.int64),
            chunk_stats=[table.get(n) for n in names])

    def column_stats(self, tensor: str, node_id: Optional[str] = None
                     ) -> Optional[manifestlib.ColumnStats]:
        """Bind-free scan index of one tensor: served from the manifest's
        column-statistics section when the node is covered (zero requests),
        None otherwise — callers fall back to binding the tensor."""
        if self.manifest is None:
            return None
        return self.manifest.column_stats(node_id or self.current_id, tensor)

    def tensor_length(self, tensor: str,
                      node_id: Optional[str] = None) -> Optional[int]:
        """Row count of a tensor without binding it (manifest scan index),
        or None when the node is uncovered."""
        cs = self.column_stats(tensor, node_id)
        return None if cs is None else cs.num_samples

    # ------------------------------------------------------------ node state
    @property
    def current(self) -> CommitNode:
        return self.commits[self.current_id]

    def writable(self) -> bool:
        return not self.current.committed

    def require_writable(self) -> None:
        if not self.writable():
            raise PermissionError(
                f"HEAD {self.current_id} is a sealed commit; checkout a branch "
                f"(or create one) before writing")

    def schema_tensors(self, node_id: Optional[str] = None) -> List[str]:
        nid = node_id or self.current_id
        if nid not in self._schemas:  # memo: one GET per node, not per view
            m = self.manifest
            if m is not None and m.covers(nid):
                self._schemas[nid] = list(m.node_schema(nid) or [])
            else:
                d = self._get_json(self._schema_key(nid), {"tensors": []})
                self._schemas[nid] = list(d["tensors"])
        return list(self._schemas[nid])

    def set_schema_tensors(self, tensors: List[str]) -> None:
        m = self.manifest
        if m is not None and m.covers(self.current_id):
            m.mark_stale(self.current_id)
        self._schemas[self.current_id] = list(tensors)
        self._put_json(self._schema_key(self.current_id), {"tensors": tensors})

    # ----------------------------------------------------------- chunk lookup
    def chunk_set(self, node_id: str, tensor: str) -> Set[str]:
        key = (node_id, tensor)
        if key not in self._chunk_sets:
            d = self._get_state_json(tensor, "chunk_set.json", node_id,
                                     {"chunks": []})
            self._chunk_sets[key] = set(d["chunks"])
            at = d.get("at") or {}
            if at:  # grafted chunks live under another node's directory
                self._chunk_home_maps[key] = dict(at)
        return self._chunk_sets[key]

    def _chunk_home(self, node_id: str, tensor: str, chunk_name: str) -> str:
        """Node whose directory physically holds a chunk owned by
        ``node_id`` (== ``node_id`` unless the chunk was grafted)."""
        return self._chunk_home_maps.get((node_id, tensor), {}) \
            .get(chunk_name, node_id)

    def resolve_chunk_key(self, tensor: str, chunk_name: str,
                          node_id: Optional[str] = None) -> str:
        """Paper §4.1 traversal: walk current -> root, first chunk_set hit
        wins; the owning node's "at" home map may redirect the physical key."""
        nid = node_id or self.current_id
        while nid is not None:
            if chunk_name in self.chunk_set(nid, tensor):
                home = self._chunk_home(nid, tensor, chunk_name)
                return self.chunk_key(home, tensor, chunk_name)
            nid = self.commits[nid].parent
        raise StorageError(f"chunk {chunk_name!r} of tensor {tensor!r} not found "
                           f"in any ancestor of {node_id or self.current_id}")

    def register_new_chunk(self, tensor: str, chunk_name: str) -> str:
        """Record a chunk created in the current (writable) version."""
        self.require_writable()
        self.chunk_set(self.current_id, tensor).add(chunk_name)
        return self.chunk_key(
            self._chunk_home(self.current_id, tensor, chunk_name),
            tensor, chunk_name)

    def put_chunk(self, tensor: str, chunk_name: str, payload: bytes) -> str:
        """Verified upload of a chunk owned by the current writable node.

        The single chokepoint for chunk durability: routes through
        :meth:`StorageProvider.put_verified` (torn uploads detected and
        re-put), honors the relocation home map (a grafted chunk re-flushes
        to its birth directory, never forks), and records where the bytes
        physically landed so a later rebase can graft without re-uploading.
        Returns the physical key written.
        """
        nid = self.current_id
        home = self._chunk_home(nid, tensor, chunk_name)
        key = self.chunk_key(home, tensor, chunk_name)
        self.storage.put_verified(key, payload)
        self._chunk_put_homes[(tensor, chunk_name)] = home
        return key

    def forget_chunk(self, tensor: str, chunk_name: str) -> None:
        self.chunk_set(self.current_id, tensor).discard(chunk_name)
        self._chunk_home_maps.get((self.current_id, tensor), {}) \
            .pop(chunk_name, None)
        self._chunk_put_homes.pop((tensor, chunk_name), None)

    def flush_chunk_set(self, tensor: str) -> None:
        nid = self.current_id
        names = self.chunk_set(nid, tensor)
        payload: dict = {"chunks": sorted(names)}
        at = {n: h for n, h in
              self._chunk_home_maps.get((nid, tensor), {}).items()
              if n in names and h != nid}
        if at:
            payload["at"] = at
        self.put_state(tensor, "chunk_set.json", json.dumps(payload).encode())

    # ------------------------------------------------------------ diff state
    def diff_of(self, tensor: str) -> CommitDiff:
        if tensor not in self._diffs:
            d = self._get_state_json(tensor, "commit_diff.json")
            self._diffs[tensor] = CommitDiff.from_json(d) if d else CommitDiff()
        return self._diffs[tensor]

    def record_append(self, tensor: str, first_idx: int, count: int) -> None:
        self.diff_of(tensor).record_append(first_idx, count)

    def record_update(self, tensor: str, idx: int) -> None:
        self.diff_of(tensor).record_update(idx)

    def record_created(self, tensor: str) -> None:
        self.diff_of(tensor).created = True

    def flush_diff(self, tensor: str) -> None:
        self.put_state(tensor, "commit_diff.json",
                       json.dumps(self.diff_of(tensor).to_json()).encode())

    def _load_current_diffs(self) -> None:
        self._diffs = {}
        for t in self.schema_tensors():
            self.diff_of(t)

    def has_uncommitted_changes(self) -> bool:
        return any(not d.is_empty() for d in self._diffs.values())

    # --------------------------------------------------------------- commit
    def commit(self, message: str = "", *, flush=None) -> str:
        """Seal the current head; open a fresh writable child on the branch.

        On manifest datasets this is the ACID publication point: complete
        snapshots of the sealed node and the fresh head are folded into a
        new manifest segment and published with one CAS pointer swap
        (:meth:`Manifest.commit_update`).  Losing the swap to a concurrent
        committer triggers an automatic **rebase-and-retry**: the pointer
        is reloaded and this writer's pending work grafted onto the winning
        history (see :meth:`_rebase_commit`), then ``flush`` (the caller's
        tensor-flush callback, re-entrant) and the publication re-run —
        bounded by ``COMMIT_REBASE_ATTEMPTS``, after which (or when the
        writers' tensor sets overlap on one branch) a typed
        :class:`CommitContendedError` surfaces.  Already-uploaded chunks
        are never re-uploaded by a rebase: cross-branch winners leave our
        head untouched, same-branch relocation grafts them via the
        chunk_set ``"at"`` home map.  Legacy (pre-manifest) datasets adopt
        a manifest on their first commit.
        """
        self.require_writable()
        last: Optional[manifestlib.ManifestConflict] = None
        for _ in range(1 + COMMIT_REBASE_ATTEMPTS):
            try:
                if flush is not None:
                    flush()
                with telemetry.span("commit.publish",
                                    branch=self.current.branch):
                    sealed = self._commit_once(message)
                self.commit_stats["commits"] += 1
                telemetry.registry().counter("commit.commits").inc()
                return sealed
            except manifestlib.ManifestConflict as e:
                if isinstance(e, CommitContendedError):
                    raise
                last = e
                self._rebase_commit(e)
        self.commit_stats["contended"] += 1
        telemetry.registry().counter("commit.contended").inc()
        raise CommitContendedError(
            f"commit gave up after {COMMIT_REBASE_ATTEMPTS} rebase "
            f"attempts on branch {self.current.branch!r}") from last

    def _commit_once(self, message: str) -> str:
        """One seal + publish attempt; rolls the in-memory seal back on a
        publication conflict so a rebase can re-run the whole commit."""
        head = self.current
        prev_diffs = self._diffs
        head.committed = True
        head.message = message
        head.timestamp = time.time()
        sealed_id = head.id
        branch = head.branch
        child = CommitNode(id=_new_id(), parent=sealed_id, branch=branch)
        head.children.append(child.id)
        self.commits[child.id] = child
        self.branches[branch] = child.id
        try:
            self._copy_state(sealed_id, child.id)
            self.current_id = child.id
            self._load_current_diffs()
            if self.manifest is None:  # legacy dataset: adopt on first commit
                self.manifest = manifestlib.Manifest.create(self.storage)
            info = self._info_dict()
            self.manifest.commit_update(
                {sealed_id: self.node_snapshot(sealed_id),
                 child.id: self.node_snapshot(child.id)},
                info, branch=branch)
        except manifestlib.ManifestConflict:
            # the publish lost: undo the seal so the head is writable again
            # (the rebase re-runs the commit); the child's loose files —
            # a few tiny JSON objects — stay behind as GC-able orphans
            head.committed = False
            head.message = None
            head.timestamp = 0.0
            if child.id in head.children:
                head.children.remove(child.id)
            self.commits.pop(child.id, None)
            self.branches[branch] = sealed_id
            self.current_id = sealed_id
            self._diffs = prev_diffs
            self._schemas.pop(child.id, None)
            self._state_cache = {k: v for k, v in self._state_cache.items()
                                 if k[0] != child.id}
            self._chunk_sets = {k: v for k, v in self._chunk_sets.items()
                                if k[0] != child.id}
            raise
        # mirror to the legacy key only AFTER the pointer swap won: a
        # conflicted commit must not advance the loose version tree either
        self._put_json(VC_INFO_KEY, info)
        self._saved_info = info
        return sealed_id

    # --------------------------------------------------------------- rebase
    def _rebase_commit(self, cause: manifestlib.ManifestConflict) -> None:
        """Graft this writer's pending (uncommitted) work onto the winning
        history after a lost publication.

        Two shapes, mirroring where concurrent writers can actually
        collide:

        * **cross-branch** — the winner moved *other* branch heads; our
          head node is untouched.  Merge the version trees (their commits
          + our local-only nodes), adopt the fresh manifest, keep our head.
          Nothing is re-uploaded, nothing relocated.
        * **same-branch** — the winner sealed the very node we were
          writing to.  Iff the two writers touched disjoint tensor sets
          (``commit_diff`` intersection along the winner's new commits),
          relocate our pending state onto a fresh head under the winner's
          newest sealed node, grafting already-uploaded chunks in place
          via the chunk_set ``"at"`` home map.  Overlap raises
          :class:`CommitContendedError`.
        """
        self.commit_stats["rebases"] += 1
        telemetry.registry().counter("commit.rebases").inc()
        with telemetry.span("commit.rebase",
                            branch=self.current.branch) as sp:
            fresh = manifestlib.Manifest.load(self.storage)
            if fresh is None or not fresh.vc_info:
                raise cause  # nothing to rebase onto: surface the original
            their_commits = {k: CommitNode.from_json(v)
                             for k, v in fresh.vc_info["commits"].items()}
            their_branches = dict(fresh.vc_info.get("branches", {}))
            head_id = self.current_id
            branch = self.current.branch
            if their_branches.get(branch, head_id) == head_id:
                sp.set(shape="adopt")
                self._adopt_tree(fresh, their_commits, their_branches,
                                 head_id=head_id, branch=branch)
            else:
                sp.set(shape="relocate")
                self._relocate_head(fresh, their_commits, their_branches,
                                    head_id=head_id, branch=branch,
                                    cause=cause)

    def _merge_trees(self, their_commits: Dict[str, CommitNode],
                     their_branches: Dict[str, str]
                     ) -> Tuple[Dict[str, CommitNode], Dict[str, str]]:
        """The winner's tree + any local-only nodes (unpublished branches),
        re-linked into their parents."""
        merged = dict(their_commits)
        for nid, node in self.commits.items():
            if nid not in merged:
                merged[nid] = node
                p = node.parent
                if p is not None and p in merged \
                        and nid not in merged[p].children:
                    merged[p].children.append(nid)
        branches = dict(their_branches)
        for b, h in self.branches.items():
            branches.setdefault(b, h)
        return merged, branches

    def _adopt_tree(self, fresh: manifestlib.Manifest,
                    their_commits: Dict[str, CommitNode],
                    their_branches: Dict[str, str], *,
                    head_id: str, branch: str) -> None:
        merged, branches = self._merge_trees(their_commits, their_branches)
        merged[head_id] = self.commits[head_id]  # keep the live head object
        branches[branch] = head_id
        self.commits = merged
        self.branches = branches
        self.manifest = fresh
        self._saved_info = fresh.vc_info
        self.commit_stats["adoptions"] += 1
        telemetry.registry().counter("commit.adoptions").inc()
        # our head's cached state is still ours (nobody sealed it); every
        # other node's state is immutable, so no cache invalidation needed

    def _relocate_head(self, fresh: manifestlib.Manifest,
                       their_commits: Dict[str, CommitNode],
                       their_branches: Dict[str, str], *,
                       head_id: str, branch: str,
                       cause: manifestlib.ManifestConflict) -> None:
        th = their_branches.get(branch)
        if th is None or th not in their_commits:
            raise cause  # the branch vanished: not linearly rebaseable
        th_node = their_commits[th]
        tp = th_node.parent if not th_node.committed else th
        if tp is None:
            raise cause
        base = self.commits[head_id].parent
        # the winner's sealed chain since our base, newest first
        path: List[str] = []
        nid: Optional[str] = tp
        while nid is not None and nid != base:
            node = their_commits.get(nid)
            if node is None:
                raise cause
            path.append(nid)
            nid = node.parent
        if nid != base:
            raise cause  # our base is not in the winner's ancestry

        ours_touched = {t for t, d in self._diffs.items() if not d.is_empty()}
        theirs_touched: Set[str] = set()
        for pnid in path:
            ns = fresh.nodes.get(pnid)
            if ns is None:
                raise cause  # cannot prove disjointness without the snapshot
            for t, files in ns.tensors.items():
                raw = files.get("commit_diff.json")
                if raw and not CommitDiff.from_json(
                        json.loads(raw.decode())).is_empty():
                    theirs_touched.add(t)
        overlap = ours_touched & theirs_touched
        if overlap:
            self.commit_stats["contended"] += 1
            telemetry.registry().counter("commit.contended").inc()
            raise CommitContendedError(
                f"concurrent commits touched the same tensors "
                f"{sorted(overlap)} on branch {branch!r}; exactly one "
                f"writer won — replay these writes on a fresh handle to "
                f"retry") from cause
        tp_state = fresh.nodes.get(tp)
        if tp_state is None:
            raise cause

        # capture our flushed state bytes for touched tensors BEFORE the
        # old head's (now foreign-owned) caches are dropped; never-flushed
        # tensors re-flush from live Tensor memory on the commit retry
        old_schema = self.schema_tensors(head_id)
        captured = {t: {f: self.get_state(t, f, head_id)
                        for f in self.STATE_FILES}
                    for t in ours_touched}

        x2 = CommitNode(id=_new_id(), parent=tp, branch=branch)
        merged, branches = self._merge_trees(their_commits, their_branches)
        merged[x2.id] = x2
        if x2.id not in merged[tp].children:
            merged[tp].children.append(x2.id)
        branches[branch] = x2.id
        self.commits = merged
        self.branches = branches
        self.manifest = fresh
        self._saved_info = fresh.vc_info
        self.current_id = x2.id

        # move in-memory chunk ownership old head -> X2; chunks whose bytes
        # already landed keep their physical home (the graft)
        grafted = 0
        for t in ours_touched:
            moved = self._chunk_sets.pop((head_id, t), set())
            self._chunk_sets[(x2.id, t)] = moved
            inherited = self._chunk_home_maps.pop((head_id, t), {})
            homes: Dict[str, str] = {}
            for name in moved:
                home = self._chunk_put_homes.get((t, name),
                                                 inherited.get(name))
                if home is not None and home != x2.id:
                    homes[name] = home
                    grafted += 1
            if homes:
                self._chunk_home_maps[(x2.id, t)] = homes
        # drop our stale view of the old head: the winner's snapshot owns it
        self._state_cache = {k: v for k, v in self._state_cache.items()
                             if k[0] != head_id}
        self._schemas.pop(head_id, None)
        self._chunk_sets = {k: v for k, v in self._chunk_sets.items()
                            if k[0] != head_id}

        new_schema = list(tp_state.schema) + [t for t in old_schema
                                              if t not in tp_state.schema]
        self._put_json(self._schema_key(x2.id), {"tensors": new_schema})
        self._schemas[x2.id] = new_schema
        for t in new_schema:
            if t in ours_touched:
                for f, raw in captured[t].items():
                    if raw is not None:
                        self.put_state(t, f, raw, x2.id)
                self.flush_chunk_set(t)  # writes the "at" home map
                self.flush_diff(t)       # live diff survives the relocation
            else:  # untouched: inherit the winner's state (like _copy_state)
                files = tp_state.tensors.get(t, {})
                for f in self.STATE_FILES:
                    raw = files.get(f)
                    if raw is not None:
                        self.put_state(t, f, raw, x2.id)
                self.put_state(t, "chunk_set.json",
                               json.dumps({"chunks": []}).encode(), x2.id)
                self.put_state(t, "commit_diff.json",
                               json.dumps(CommitDiff().to_json()).encode(),
                               x2.id)
        self.commit_stats["relocations"] += 1
        self.commit_stats["grafted_chunks"] += grafted
        reg = telemetry.registry()
        reg.counter("commit.relocations").inc()
        reg.counter("commit.grafted_chunks").inc(grafted)

    def _copy_state(self, src_id: str, dst_id: str) -> None:
        """Copy small per-tensor state files; chunks stay where created."""
        tensors = self.schema_tensors(src_id)
        self._put_json(self._schema_key(dst_id), {"tensors": tensors})
        self._schemas[dst_id] = list(tensors)
        for t in tensors:
            for fname in self.STATE_FILES:
                raw = self.get_state(t, fname, src_id)
                if raw is not None:
                    self.put_state(t, fname, raw, dst_id)
            self.put_state(t, "chunk_set.json",
                           json.dumps({"chunks": []}).encode(), dst_id)
            self.put_state(t, "commit_diff.json",
                           json.dumps(CommitDiff().to_json()).encode(), dst_id)

    # -------------------------------------------------------------- checkout
    def resolve_ref(self, ref: str) -> str:
        if ref in self.branches:
            return self.branches[ref]
        if ref in self.commits:
            return ref
        raise KeyError(f"unknown branch or commit: {ref!r}")

    def checkout(self, ref: str, create: bool = False) -> str:
        if create:
            if ref in self.branches:
                raise ValueError(f"branch {ref!r} exists")
            base = self.current
            if not base.committed and self.has_uncommitted_changes():
                # paper/deeplake behavior: branching with dirty head auto-commits
                self.commit(f"auto-commit before branch {ref!r}")
                base = self.commits[self.current.parent]  # the sealed node
            parent_id = base.id if base.committed else base.parent
            node = CommitNode(id=_new_id(), parent=parent_id, branch=ref)
            self.commits[node.id] = node
            if parent_id is not None:
                self.commits[parent_id].children.append(node.id)
                self._copy_state(parent_id, node.id)
            else:
                self._put_json(self._schema_key(node.id), {"tensors": []})
                self._schemas[node.id] = []
            self.branches[ref] = node.id
            self.current_id = node.id
        else:
            self.current_id = self.resolve_ref(ref)
        self._load_current_diffs()
        self.save_info()
        return self.current_id

    # ------------------------------------------------------------------ log
    def log(self, ref: Optional[str] = None) -> List[CommitNode]:
        nid: Optional[str] = self.resolve_ref(ref) if ref else self.current_id
        out: List[CommitNode] = []
        while nid is not None:
            node = self.commits[nid]
            if node.committed:
                out.append(node)
            nid = node.parent
        return out

    def ancestry(self, node_id: str) -> List[str]:
        out = []
        nid: Optional[str] = node_id
        while nid is not None:
            out.append(nid)
            nid = self.commits[nid].parent
        return out

    def lowest_common_ancestor(self, a: str, b: str) -> Optional[str]:
        anc_a = set(self.ancestry(a))
        for nid in self.ancestry(b):
            if nid in anc_a:
                return nid
        return None

    # ----------------------------------------------------------------- diff
    def diff_between(self, ref_a: str, ref_b: str) -> Dict[str, Dict[str, dict]]:
        """Per-tensor changes on each side since the LCA: {'a': {...}, 'b': {...}}."""
        a, b = self.resolve_ref(ref_a), self.resolve_ref(ref_b)
        lca = self.lowest_common_ancestor(a, b)

        def path_diffs(nid: str) -> Dict[str, dict]:
            acc: Dict[str, CommitDiff] = {}
            cur: Optional[str] = nid
            while cur is not None and cur != lca:
                for t in self.schema_tensors(cur):
                    d = self._get_state_json(t, "commit_diff.json", cur)
                    if d:
                        cd = CommitDiff.from_json(d)
                        if cd.is_empty():
                            continue
                        tgt = acc.setdefault(t, CommitDiff())
                        if cd.added_count:
                            if tgt.added_count == 0 or cd.added_first < tgt.added_first:
                                tgt.added_first = cd.added_first if tgt.added_count == 0 \
                                    else min(tgt.added_first, cd.added_first)
                            tgt.added_count += cd.added_count
                        tgt.updated |= cd.updated
                        tgt.created |= cd.created
                cur = self.commits[cur].parent
            return {t: d.to_json() for t, d in acc.items()}

        return {"a": path_diffs(a), "b": path_diffs(b), "lca": lca}
