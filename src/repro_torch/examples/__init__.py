"""Runnable examples of the port, the counterparts of the reference's
``examples/``: ``python -m repro_torch.examples.<name>``.

``cluster_sim`` and ``calibrate`` are NumPy only and print the reference's
text; ``quickstart``, ``train_lm`` and ``serve_batch`` put tensors on
``--device`` (default ``cuda``; ``cpu`` runs without a card).
"""
