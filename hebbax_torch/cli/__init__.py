"""Entry points: ``python -m hebbax_torch.cli.<name>``."""
