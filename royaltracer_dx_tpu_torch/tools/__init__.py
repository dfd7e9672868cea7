"""Seeded adversarial inputs for the card tests and ``chip_smoke.py``."""
