"""Retrieval-library helpers of the port."""
