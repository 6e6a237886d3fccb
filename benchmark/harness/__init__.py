"""The benchmark's harness: one run of one cell (``run.py``), the traffic
generator, the analytic operation and byte counts, the probe that collects
spans, counters and the profiler's trace, and the cells' drivers."""
