"""Kernel dispatch helpers."""
