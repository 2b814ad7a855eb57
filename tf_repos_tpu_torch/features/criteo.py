"""Criteo feature-map helpers (the port's own copy of the part of the JAX
package's features/criteo.py that --field_blocks=auto:<feature_map>
needs; the preprocessor itself is not ported yet).

A feature_map holds one ``<key> <id>`` line per feature: ``I<i> <i>`` for
the continuous fields, ``C<j>|<value> <id>`` for each categorical value,
each categorical field's ids forming one contiguous block."""

from __future__ import annotations

from typing import Dict, List, Tuple

NUM_CONTINUOUS = 13


def field_blocks_from_feature_map(path: str) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(offsets, sizes) of each field's contiguous id block. Continuous
    field i occupies the single id i; categorical C<j> spans
    [min id, max id] of its values."""
    cat_ids: Dict[int, List[int]] = {}
    with open(path) as f:
        for line in f:
            key, vid = line.rsplit(" ", 1)
            if key.startswith("C") and "|" in key:
                j = int(key.split("|")[0][1:])
                cat_ids.setdefault(j, []).append(int(vid))
    offsets = list(range(1, NUM_CONTINUOUS + 1))
    sizes = [1] * NUM_CONTINUOUS
    for j in sorted(cat_ids):
        lo, hi = min(cat_ids[j]), max(cat_ids[j])
        offsets.append(lo)
        sizes.append(hi - lo + 1)
    return tuple(offsets), tuple(sizes)
