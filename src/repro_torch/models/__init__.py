"""The LM model families (``repro/models``): pure functions on dicts of
tensors, built from ``ParamDecl`` trees."""
from repro_torch.models.transformer import (  # noqa: F401
    ModelBundle, build_model, input_specs,
)
