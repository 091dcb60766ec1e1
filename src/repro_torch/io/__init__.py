"""I/O: the log-structured container (format, spatial index, planners,
engines with the kernel-bypass ``uring`` and ``odirect``, ``engine="auto"``,
the distributed reorganization's journal, the pattern helpers) copied from
the JAX package, the :class:`Dataset` session whose writes, reads, decomposed
pattern reads and :func:`reorganize` run through the copy kernels on the
card (:mod:`.device`), and the :class:`StagingExecutor` that assembles a
staged layout on the card while the producer computes."""

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
from .spatial import SpatialChunkIndex
from .staging import StageResult, StagingExecutor

__all__ = [n for n in dir() if not n.startswith("_")]
