"""MetaGMRF: a metadata-carrying wrapper that forwards all distribution ops.

Counterpart of ``tpu_gmrf.metagmrf`` (reference src/metagmrf.jl:12-81):
domain layers attach semantic metadata (e.g. a spatiotemporal
discretization) to a GMRF without subclassing the distribution; every
statistic forwards to the inner GMRF. The reference registers a pytree with
the metadata in its static slot; torch has no pytrees, so this is a plain
class.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["GMRFMetadata", "MetaGMRF"]


class GMRFMetadata:
    """Base class for metadata attached to a MetaGMRF. Subclass freely."""


@dataclasses.dataclass
class MetaGMRF:
    inner: Any
    metadata: Any

    def __len__(self):
        return len(self.inner)

    def __getattr__(self, name):
        # dataclass fields resolve normally; everything else forwards
        if name in ("inner", "metadata"):
            raise AttributeError(name)
        return getattr(self.inner, name)

    def __repr__(self):
        return f"MetaGMRF({self.metadata!r}, n={len(self.inner)})"
