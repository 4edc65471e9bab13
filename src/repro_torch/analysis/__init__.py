"""Launch analysis (``repro/analysis/``): the per-device cost recorder
(``cost.py``), the roofline over it (``roofline.py``) and the op-log
inspection helpers (``opdebug.py``)."""
