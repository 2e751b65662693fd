"""Deep Lake core: the paper's contribution (storage format C1, version
control C2, TQL C3, materialization C4, streaming dataloader C5)."""

from . import telemetry
from .chunk_encoder import ChunkEncoder
from .chunks import ChunkBuilder, parse_header, read_all_samples
from .codecs import available as available_codecs, get_codec
from .dataset import Dataset, Group, MergeConflict, dataset, empty_like
from .fetch import (FetchEngine, RetryPolicy, coalescing_disabled,
                    coalescing_enabled, engine_for)
from .htypes import available_htypes, get_htype, parse_htype
from .maintenance import MaintenanceReport, MaintenanceRunner
from .manifest import Manifest, ManifestConflict
from .serving import CachedResult, QueryService
from .storage import (FaultPolicy, LocalProvider, LRUCacheProvider,
                      MemoryProvider, RetryExhausted, SimulatedS3Provider,
                      StorageError, StorageProvider, StorageTimeout,
                      TornReadError, TornWriteError, TransientStorageError,
                      chain, coalesce_ranges, retry_transient,
                      storage_from_path)
from .telemetry import (MetricsRegistry, Tracer, attribute_stall,
                        provider_snapshot, tracing)
from .tensor import Tensor, TensorMeta
from .version_control import CommitContendedError, VersionControl
from .views import DatasetView, TensorView

__all__ = [
    "CachedResult", "ChunkBuilder", "ChunkEncoder", "CommitContendedError",
    "Dataset",
    "DatasetView", "FaultPolicy",
    "FetchEngine", "Group", "LRUCacheProvider", "LocalProvider",
    "MaintenanceReport", "MaintenanceRunner", "Manifest", "ManifestConflict",
    "MemoryProvider", "MergeConflict", "MetricsRegistry", "QueryService",
    "RetryExhausted", "RetryPolicy",
    "SimulatedS3Provider", "StorageError", "StorageProvider",
    "StorageTimeout", "Tensor", "TensorMeta", "TensorView", "TornReadError",
    "TornWriteError", "Tracer", "TransientStorageError", "VersionControl",
    "attribute_stall", "available_codecs",
    "available_htypes", "chain", "coalesce_ranges", "coalescing_disabled",
    "coalescing_enabled", "dataset", "empty_like", "engine_for", "get_codec",
    "get_htype", "parse_htype", "provider_snapshot", "read_all_samples",
    "retry_transient", "storage_from_path", "telemetry", "tracing",
]
