"""Synthetic camera fleet and detection streams (numpy only)."""
