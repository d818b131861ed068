"""Tools of the port: the measurement probes (``perf_lab``, run on the GPU), the
checkpoint converter, the ground-truth tools and the evaluation (``eval``)."""
