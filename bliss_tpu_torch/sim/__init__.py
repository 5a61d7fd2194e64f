"""Similarity on force vectors."""
