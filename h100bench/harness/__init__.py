"""The benchmark harness: cells, traffic, spans, traces, statistics, checks."""
