"""I/O: the log-structured container (format, spatial index, planners,
engines with the kernel-bypass ``uring`` and ``odirect``, ``engine="auto"``,
the distributed reorganization's journal, the pattern helpers) copied from
the JAX package, the :class:`Dataset` session whose writes, reads, decomposed
pattern reads and :func:`reorganize` run through the copy kernels on the
card (:mod:`.device`), the :class:`StagingExecutor` that assembles a
staged layout on the card while the producer computes, and workload traces:
capture (:class:`TraceRecorder`, copied from the JAX package) and
:func:`replay_trace`, which drives a trace through the port's stack on the
card to the JAX package's digest; :func:`gather_to_nodes`, the intra-node
aggregation, copies each non-leader block on its own device."""

from .aggregation import gather_to_nodes
from .engine import (ENGINES, IOEngine, MemmapEngine, ODirectEngine,
                     OverlappedPreadEngine, PreadEngine, SubfileStore,
                     UringEngine, WriteStats, assemble_chunk, get_engine,
                     resolve_engine, scatter_row, validate_engine_spec)
from .format import ChunkRecord, DatasetIndex, VarRows, extent_checksum
from .journal import (REORG_JOURNAL_NAME, ReorgJournal, WorkUnit,
                      partition_unit_rows)
from .patterns import (drive_pattern_mix, measure_pattern_mix, normalize_mix,
                       resolve_pattern)
from .planner import (ReadPlan, WritePlan, build_read_plan, build_span_plan,
                      build_write_plan, linear_candidates, subset_write_plan)
from .reader import Dataset, ReadStats, choose_reorg_layout, reorganize
from .replay import (REPLAY_EPOCH, ReplayClock, ReplayError, ReplayResult,
                     replay_trace)
from .spatial import SpatialChunkIndex
from .staging import StageResult, StagingExecutor
from .trace import (TRACE_NAME, TRACE_VERSION, Trace, TraceCorruptError,
                    TraceError, TraceEvent, TraceHeader, TraceRecorder,
                    TraceSchemaError, header_for_dataset, load_trace)

__all__ = [n for n in dir() if not n.startswith("_")]
