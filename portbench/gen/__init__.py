"""The seeded genome and request generators."""
