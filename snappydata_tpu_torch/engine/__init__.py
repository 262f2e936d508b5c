"""Plan compiler, executor and host-side result finishing."""
