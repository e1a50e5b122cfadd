"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart`` (the Session pipeline end to end) and ``train_100m`` (a
~100M-parameter dense LM with checkpoint/restart)."""
