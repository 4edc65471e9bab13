"""Command-line entry points (``repro/launch``): ``serve``, ``train``, and
the device meshes they build (``mesh``)."""
