"""Batched LM serving (``repro/serve``)."""
from repro_torch.serve.engine import ServeEngine  # noqa: F401
