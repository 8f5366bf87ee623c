"""Progress reporting for long host-side loops.

The two host-bound loops — reading thousands of npz files and writing
per-spectrum predictions — show a tqdm bar when tqdm is importable and the
workload is big enough to care, and stay silent otherwise (so tests and
small runs stay clean).
"""

from __future__ import annotations

from typing import Iterable, Iterator

__all__ = ["progress"]

#: workloads below this many items never show a bar
MIN_ITEMS = 512


def progress(
    iterable: Iterable,
    desc: str = "",
    total: int | None = None,
    min_items: int = MIN_ITEMS,
) -> Iterator:
    """Wrap an iterable with a tqdm bar for big host-side workloads.

    No-op (returns the iterable unchanged) when the total is unknown or
    small, or when tqdm is unavailable — never a hard dependency.
    """
    if total is None:
        total = getattr(iterable, "__len__", lambda: None)()
    if total is None or total < min_items:
        return iter(iterable)
    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover - tqdm is present in dev images
        return iter(iterable)
    return iter(tqdm(iterable, desc=desc, total=total, leave=False))
