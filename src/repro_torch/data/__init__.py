"""The synthetic LM data pipeline (``repro/data``)."""
from repro_torch.data.pipeline import SyntheticLMPipeline  # noqa: F401
