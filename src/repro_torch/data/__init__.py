"""Synthetic language-model data."""
