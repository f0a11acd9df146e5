"""Test and drill helpers of the port (fault injection)."""
