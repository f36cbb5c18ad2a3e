"""Demos of the port (``python -m gstk_torch.examples.<name>``)."""
