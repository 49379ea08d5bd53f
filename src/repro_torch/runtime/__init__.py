"""Failure detection, stragglers and elastic re-mesh (host control plane)."""
