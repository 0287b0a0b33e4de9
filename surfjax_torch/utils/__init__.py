"""Utilities around the renderer (counterpart of `surfjax/utils/`)."""
