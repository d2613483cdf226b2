"""Command-line tools of the port (``python -m compeg_tpu_torch.tools.<name>``)."""
