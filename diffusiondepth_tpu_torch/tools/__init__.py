"""Command-line tools: the split-json generator (``generate_json``)."""
