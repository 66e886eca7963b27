"""The data layer: LLFF frames, the event stream, samplers, prefetch."""

from .llff import LLFFDataset, RandomRaySampler, ImageBatchSampler  # noqa: F401
from .events import LLFFEventsDataset, RandomEventSampler  # noqa: F401
from .pipeline import Prefetcher, endless  # noqa: F401
