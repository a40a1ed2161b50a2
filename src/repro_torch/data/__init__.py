"""Hash-powered data pipeline of the port (Bloom/dedup admission)."""
from . import dedup, pipeline, synthetic  # noqa: F401
from .dedup import BloomFilter, ExactDedup  # noqa: F401
from .pipeline import HashPipeline, PipelineConfig  # noqa: F401
