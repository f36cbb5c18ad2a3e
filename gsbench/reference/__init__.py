"""The plain PyTorch reference that decides ``correct`` (no program imports)."""
