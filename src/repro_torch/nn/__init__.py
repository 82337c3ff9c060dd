"""Shared neural-network helpers."""
