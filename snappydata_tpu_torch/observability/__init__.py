"""Process-wide counters."""
