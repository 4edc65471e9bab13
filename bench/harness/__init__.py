"""The benchmark's own machinery: the run loop (``runner``), the traffic
generators (``traffic``), the profiler reduction (``trace``), the frozen
kernel work counts (``kernel_work``) and the table of peaks (``peaks``).
Nothing here imports the JAX package; the port is imported only by the
configuration modules, as the system under test."""
