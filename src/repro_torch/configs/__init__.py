"""Machine configurations (copies of ``repro/configs``)."""
