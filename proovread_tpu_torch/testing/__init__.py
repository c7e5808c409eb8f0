"""Test support importable from the package (the driver calls the
fault-injection hooks without importing from ``tests/``)."""
