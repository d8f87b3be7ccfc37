"""Slice awareness: slice identity inference and slice-state aggregation."""
