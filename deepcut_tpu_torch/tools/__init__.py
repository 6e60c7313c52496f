"""Command-line front end of the port (`python -m deepcut_tpu_torch.tools.cli`)."""
