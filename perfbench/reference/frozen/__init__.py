"""Frozen copies of the port's plain modules (kytpu_torch at 35fb5ad)."""
