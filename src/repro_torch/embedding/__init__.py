"""Embedding substrate: dedup working sets and packed multi-field tables."""
