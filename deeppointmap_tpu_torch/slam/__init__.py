"""The inference engine."""
