"""Shared pattern-read helpers, copied from the JAX package.

Region resolution for the paper's Fig.-6 patterns plus the mix helpers used
by :meth:`repro_torch.io.reader.Dataset.read_pattern` and the layout policy
— one place for the slab-thickness-kwargs convention and the "read this mix
of patterns" loop.

A *mix* is a sequence of ``(pattern_name, weight)`` pairs (weights are
relative; they need not sum to anything).  ``drive_pattern_mix`` makes
weight-proportional real reads (populating the dataset's access log — the
telemetry the layout policy learns from);
``measure_pattern_mix`` times the same mix best-of-``repeats`` and returns
the weighted read seconds, which is how the layout-policy benchmark compares
candidate layouts on equal terms.
"""

from __future__ import annotations

from typing import Sequence

from ..core.blocks import Block
from ..core.read_patterns import pattern_region

__all__ = ["resolve_pattern", "normalize_mix", "mix_counts",
           "drive_pattern_mix", "measure_pattern_mix"]


def resolve_pattern(shape: Sequence[int], pattern: str,
                    slab_thickness: int | None = None) -> Block:
    """The region a named Fig.-6 pattern selects from a variable of
    ``shape`` — one place for the "only forward slab_thickness when the
    caller set it" convention (the pattern functions keep their own
    defaults)."""
    kwargs = {}
    if slab_thickness is not None:
        kwargs["slab_thickness"] = slab_thickness
    return pattern_region(pattern, shape, **kwargs)


def normalize_mix(mix) -> list:
    """``[(pattern, weight)]`` with weights scaled to sum to 1."""
    pairs = [(p, float(w)) for p, w in mix]
    total = sum(w for _, w in pairs)
    if total <= 0:
        raise ValueError(f"mix has no positive weight: {mix!r}")
    return [(p, w / total) for p, w in pairs]


def mix_counts(mix) -> list:
    """``[(pattern, reads_per_round)]`` preserving the mix proportions.

    Integer weights are taken as counts verbatim; fractional mixes (e.g.
    normalized ``0.8 / 0.2``) are scaled so the smallest weight makes one
    read — the proportions, which are what the access log (and therefore
    the layout policy) learns from, survive either spelling."""
    pairs = [(p, float(w)) for p, w in mix]
    if any(w <= 0 for _, w in pairs):
        raise ValueError(f"mix weights must be positive: {mix!r}")
    smallest = min(w for _, w in pairs)
    scale = 1.0 if smallest >= 1.0 else 1.0 / smallest
    return [(p, max(1, int(round(w * scale)))) for p, w in pairs]


def drive_pattern_mix(ds, var: str, mix, *, rounds: int = 1,
                      slab_thickness: int | None = None,
                      engine=None) -> dict:
    """Make real ``Dataset.read`` calls in proportion to the mix weights
    (``rounds`` x :func:`mix_counts` reads per pattern) so the dataset's
    access log observes the mix; each read returns a tensor on the
    session's device.  Returns ``{pattern: merged ReadStats}``."""
    shape = ds.index.var_shape(var)
    out: dict = {}
    counts = mix_counts(mix)
    for _ in range(max(1, rounds)):
        for pattern, count in counts:
            region = resolve_pattern(shape, pattern, slab_thickness)
            for _i in range(count):
                _, st = ds.read(var, region, engine=engine)
                if pattern in out:
                    prev = out[pattern]
                    prev.merge(st)
                    prev.seconds += st.seconds
                else:
                    out[pattern] = st
    return out


def measure_pattern_mix(ds, var: str, mix, *, repeats: int = 3,
                        slab_thickness: int | None = None,
                        engine=None) -> tuple:
    """Best-of-``repeats`` measured read seconds per pattern, combined into
    the weighted mix time.  Returns ``(weighted_seconds, {pattern:
    best_seconds})``.  Timing uses ``ReadStats.seconds`` (probe + plan +
    execution) so candidates are compared on the full read path."""
    shape = ds.index.var_shape(var)
    per: dict = {}
    for pattern, _w in normalize_mix(mix):
        region = resolve_pattern(shape, pattern, slab_thickness)
        best = None
        for _ in range(max(1, repeats)):
            _, st = ds.read(var, region, engine=engine)
            best = st.seconds if best is None else min(best, st.seconds)
        per[pattern] = best
    weighted = sum(w * per[p] for p, w in normalize_mix(mix))
    return weighted, per
