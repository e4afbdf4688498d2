"""Command-line tools: the split-json generator (``generate_json``) and
K10's plan sweep on the card (``layernorm_bwd_sweep``)."""
