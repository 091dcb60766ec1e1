"""I/O: the log-structured container (format, spatial index, planners,
engines) copied from the JAX package, and the :class:`Dataset` session
whose write and whole-variable read run through the copy kernels on the
card (:mod:`.device`)."""

from .engine import (ENGINES, IOEngine, MemmapEngine, OverlappedPreadEngine,
                     PreadEngine, SubfileStore, WriteStats, assemble_chunk,
                     get_engine, scatter_row)
from .format import ChunkRecord, DatasetIndex, VarRows, extent_checksum
from .planner import (ReadPlan, WritePlan, build_read_plan, build_span_plan,
                      build_write_plan)
from .reader import Dataset, ReadStats
from .spatial import SpatialChunkIndex

__all__ = [n for n in dir() if not n.startswith("_")]
