"""The user-facing scripts of the JAX package's ``tools/`` and
``examples/``, as modules of the port (``python -m
flowonthego_tpu_torch.tools.<name>``): ``flow_stream``, ``flow_eval``,
``color_flow`` and ``stream_alley``, with the same flags and output
lines, plus ``--device`` where a script computes flow."""
