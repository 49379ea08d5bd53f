"""Checksummed, atomic, async checkpoints."""
